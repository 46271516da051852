"""A battery of the sharded engine's calls on a (data, model) mesh, at toy
sizes: one process per device, every rank running the same cases.

Inputs come from ``make_inputs(seed, data)`` (numpy only) through an
``.npz`` file, so that another implementation can compute the same cases
from the same arrays.  Each rank runs every case (lookups under every
policy on both wires, routed lookups and updates with their drop counts,
the hot-row cache, the sparse updates, the hybrid collection, the sparse
train step, the gradients of the lookups w.r.t. the storage (and the hot
cache's rows), and the dense-autodiff train step) and writes what it computed, gathered to the
global batch and the global tables, to ``<out>/rank<r>.npz``.  A gradient
is that of ``sum(lookup * w)`` for a fixed cotangent ``w``, each process
taking its data row's part of ``w`` where its query is data-sharded.  A case that raises records
its error as ``<case>/error``, so that a failure names its case and no
rank waits for a collective that another skipped.

    python -m pim_embedding_lookup_tpu_torch.mesh_battery \\
        RANK WORLD DATA MODEL INIT_FILE IN_NPZ OUT_DIR cpu|cuda [main|int8]

The process group is joined through ``INIT_FILE`` (a file store): gloo on
the CPU, NCCL on the card; the device has no default.  The last argument
picks the case group: the
battery above ("main", the default) or the int8 capacity mode's cases
(``Int8Battery``: ``QuantizedEmbeddingCollection`` lookups broadcast, data
sharded and routed, with and without the hot-row cache, in both scale
modes, and the ROW_HASH hybrid DLRM served from
``quantize_dlrm_embeddings``).
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from . import config as tcfg
from .config import ShardingPolicy
from .convert import params_from_jax
from .models import DLRM, fit, make_optimizer, make_train_step, quantize_dlrm_embeddings
from .models.sparse_train import make_sparse_train_state, make_sparse_train_step
from .parallel.collection import EmbeddingCollection
from .parallel.hotcache import build_hot_cache, hot_ids_from_sample
from .parallel.hybrid import HybridEmbeddingCollection
from .parallel.mesh import DATA_AXIS, MODEL_AXIS, init_distributed, make_mesh
from .parallel.quantized_collection import QuantizedEmbeddingCollection
from .parallel.sparse_update import init_accumulator, sparse_update, sparse_update_csr

ROWS = (100, 1000, 37, 4000)
DIM = 16
BATCH = 16
POOLING = 5
MIXED_ROWS = (3, 24, 583, 1460, 9000, 20000)  # 4 small tables, 2 big
MLP_BOT, MLP_TOP, DENSE_DIM = (32, 16), (32, 1), 13
TRAIN_STEPS = 3
LR = 0.05
HOT_K = 16
POISON = 1 << 30  # padding ids: a read would fault on the card
POLICIES = ("replicate", "row", "row_hash", "column", "table_wise")
# cases whose results compound three steps, and results that pass through
# bf16 (the hybrid small set's gradient): their comparisons' tolerances widen
TRACE_CASES = ("train_routed_trace", "train_hot", "train_autodiff_trace", "fit-row_hash")
BF16_RESULTS = (("grad_hybrid", "small"),)
ROWISH = ("row", "row_hash", "table_wise")


def tables(mod, rows):
    return tuple(mod.TableConfig(num_rows=n, dim=DIM, name=f"t{i}") for i, n in enumerate(rows))


def mixed_config(mod):
    return mod.DLRMConfig(dense_dim=DENSE_DIM, mlp_bot=MLP_BOT, mlp_top=MLP_TOP,
                          tables=tables(mod, MIXED_ROWS))


def _csr(rng, rows, nd):
    """Ragged bags (0..4 ids, some empty) as one global CSR [T, C], [T, B+1]
    with POISON padding, and as ``nd`` data-shard windows [T, Nd*Cd],
    [T, Nd*(Bd+1)] (shard_csr's layout)."""
    t, bd = len(rows), BATCH // nd
    bags = [[rng.integers(0, n, size=rng.integers(0, 5)).tolist() for _ in range(BATCH)]
            for n in rows]
    cap = max(sum(map(len, b)) for b in bags) + 3
    cd = max(sum(len(x) for x in b[d * bd:(d + 1) * bd]) for b in bags for d in range(nd)) + 2
    idx = np.full((t, cap), POISON, np.int32)
    off = np.zeros((t, BATCH + 1), np.int32)
    widx = np.full((t, nd * cd), POISON, np.int32)
    woff = np.zeros((t, nd * (bd + 1)), np.int32)
    for ti, b in enumerate(bags):
        flat = [i for x in b for i in x]
        idx[ti, :len(flat)] = flat
        off[ti, 1:] = np.cumsum([len(x) for x in b])
        for d in range(nd):
            win = b[d * bd:(d + 1) * bd]
            flat = [i for x in win for i in x]
            widx[ti, d * cd:d * cd + len(flat)] = flat
            woff[ti, d * (bd + 1) + 1:(d + 1) * (bd + 1)] = np.cumsum([len(x) for x in win])
    return idx, off, widx, woff


def make_inputs(seed: int, data: int) -> dict[str, np.ndarray]:
    """Every input of the battery, from ``seed``; CSR windows for a data
    axis of size ``data``."""
    rng = np.random.default_rng(seed)
    t = len(ROWS)
    inp = {f"table{i}": rng.standard_normal((n, DIM)).astype(np.float32)
           for i, n in enumerate(ROWS)}
    inp["idx"] = np.stack([rng.integers(0, n, BATCH * POOLING) for n in ROWS]).astype(np.int32)
    inp["mask"] = rng.random((t, BATCH * POOLING)) < 0.7
    # zipf ids: a few rows take most entries, so buckets overflow at low cf
    inp["zidx"] = np.stack([(rng.zipf(1.3, BATCH * POOLING) - 1) % n
                            for n in ROWS]).astype(np.int32)
    inp["zmask"] = rng.random((t, BATCH * POOLING)) < 0.9
    inp["cidx"], inp["coff"], inp["widx"], inp["woff"] = _csr(rng, ROWS, data)
    inp["g"] = rng.standard_normal((BATCH, t, DIM)).astype(np.float32)
    for i, n in enumerate(MIXED_ROWS):
        inp[f"mtable{i}"] = (rng.standard_normal((n, DIM)) * 0.1).astype(np.float32)
    nf = len(MIXED_ROWS) + 1
    sizes = {"bot": [DENSE_DIM, *MLP_BOT], "top": [DIM + nf * (nf - 1) // 2, *MLP_TOP]}
    for name, dims in sizes.items():
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            inp[f"{name}{j}_w"] = (rng.standard_normal((a, b)) * np.sqrt(2 / (a + b))).astype(
                np.float32)
            inp[f"{name}{j}_b"] = (rng.standard_normal(b) * 0.1).astype(np.float32)
    for s in range(TRAIN_STEPS):
        inp[f"mdense{s}"] = rng.random((BATCH, DENSE_DIM), dtype=np.float32)
        inp[f"midx{s}"] = np.stack([(rng.zipf(1.5, BATCH * 2) - 1) % n
                                    for n in MIXED_ROWS]).astype(np.int32)
        inp[f"mmask{s}"] = rng.random((len(MIXED_ROWS), BATCH * 2)) < 0.8
        inp[f"mlabels{s}"] = (rng.random(BATCH) < 0.5).astype(np.float32)
    inp["mg"] = rng.standard_normal((BATCH, len(MIXED_ROWS), DIM)).astype(np.float32)
    return inp


def host_tables(inp, prefix, rows):
    return [inp[f"{prefix}{i}"] for i in range(len(rows))]


def mlp_params(inp) -> dict:
    """The dense tower's params as the JAX package's tree (numpy)."""
    out = {}
    for name in ("bot", "top"):
        n = len(MLP_BOT) if name == "bot" else len(MLP_TOP)
        out[name] = [{"w": inp[f"{name}{j}_w"], "b": inp[f"{name}{j}_b"]} for j in range(n)]
    return out


class Battery:
    """The cases on one rank; ``run`` returns {name/key: global array}."""

    def __init__(self, mesh, inp):
        self.mesh, self.inp, self.dev = mesh, inp, mesh.device

    # -- helpers ----------------------------------------------------------

    def t(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.dev)

    def rows(self, x, dim=1):
        """This data row's slice of a global dense-wire batch array."""
        return self.t(self.mesh.data_slice(x, dim))

    def batch(self, x):
        """A [Bd, ...] result of this data row, gathered to [B, ...]."""
        return self.mesh.all_gather(x.contiguous(), DATA_AXIS, 0)

    def loaded(self, policy):
        c = EmbeddingCollection.create(tables(tcfg, ROWS), ShardingPolicy(policy),
                                       packed="auto", mesh=self.mesh)
        return c, c.device_put_tables(host_tables(self.inp, "table", ROWS))

    # -- cases ------------------------------------------------------------

    def lookup(self, policy, combiner):
        c, fused = self.loaded(policy)
        out = c.lookup(fused, self.rows(self.inp["idx"]), self.rows(self.inp["mask"]),
                       batch_size=BATCH // self.mesh.data, combiner=combiner)
        return {"out": self.batch(out)}

    def csr(self, policy, combiner):
        c, fused = self.loaded(policy)
        return {"out": c.lookup_csr(fused, self.t(self.inp["cidx"]), self.t(self.inp["coff"]),
                                    combiner=combiner)}

    def csr_window(self):
        return [self.t(x) for x in self.mesh.csr_window(self.inp["widx"], self.inp["woff"])]

    def csr_ds(self, policy, combiner):
        c, fused = self.loaded(policy)
        out = c.lookup_csr(fused, *self.csr_window(), combiner=combiner, data_sharded=True)
        return {"out": self.batch(out)}

    def routed(self, policy, combiner, cf=None):
        c, fused = self.loaded(policy)
        out, dropped = c.lookup_routed(
            fused, self.rows(self.inp["zidx"]), self.rows(self.inp["zmask"]),
            batch_size=BATCH // self.mesh.data, capacity_factor=cf, return_stats=True,
            combiner=combiner)
        return {"out": self.batch(out), "dropped": dropped}

    def csr_routed(self, policy, combiner, data_sharded=False, cf=None):
        c, fused = self.loaded(policy)
        q = (self.csr_window() if data_sharded
             else (self.t(self.inp["cidx"]), self.t(self.inp["coff"])))
        out, dropped = c.lookup_csr(fused, *q, combiner=combiner, data_sharded=data_sharded,
                                    routed=True, capacity_factor=cf, return_stats=True)
        return {"out": self.batch(out) if data_sharded else out, "dropped": dropped}

    def hot(self, policy):
        c, fused = self.loaded(policy)
        hot_ids = hot_ids_from_sample(c, self.inp["zidx"], HOT_K)
        ids, rows = build_hot_cache(c, fused, hot_ids)
        out, dropped = c.lookup_routed(
            fused, self.rows(self.inp["zidx"]), self.rows(self.inp["zmask"]),
            batch_size=BATCH // self.mesh.data, hot_cache=(ids, rows), return_stats=True,
            capacity_factor=1.0)
        return {"hot_ids": ids, "hot_rows": rows, "out": self.batch(out), "dropped": dropped}

    def update(self, policy, optimizer, routed=False, cf=None, zipf=False):
        c, fused = self.loaded(policy)
        acc = init_accumulator(c)
        key = "z" if zipf else ""
        _, _, dropped = sparse_update(
            c, fused, acc, self.rows(self.inp[key + "idx"]), self.rows(self.inp[key + "mask"]),
            self.rows(self.inp["g"], 0), lr=0.1, optimizer=optimizer, routed=routed,
            capacity_factor=cf, return_stats=True)
        return {"table": c.gather_storage(fused), "acc": c.gather_accumulator(acc),
                "dropped": dropped}

    def update_csr(self, policy, data_sharded=False, routed=False):
        c, fused = self.loaded(policy)
        acc = init_accumulator(c)
        if data_sharded:
            q, g = self.csr_window(), self.rows(self.inp["g"], 0)
        else:
            q, g = (self.t(self.inp["cidx"]), self.t(self.inp["coff"])), self.t(self.inp["g"])
        _, _, dropped = sparse_update_csr(c, fused, acc, *q, g, lr=0.1,
                                          optimizer="row_adagrad", routed=routed,
                                          data_sharded=data_sharded, return_stats=True)
        return {"table": c.gather_storage(fused), "acc": c.gather_accumulator(acc),
                "dropped": dropped}

    def hybrid(self, policy="row_hash"):
        h = HybridEmbeddingCollection.create(tables(tcfg, MIXED_ROWS), ShardingPolicy(policy),
                                             mesh=self.mesh)
        return h, h.device_put_tables(host_tables(self.inp, "mtable", MIXED_ROWS))

    def hybrid_lookups(self):
        h, params = self.hybrid()
        idx, mask = self.inp["midx0"], self.inp["mmask0"]
        bd = BATCH // self.mesh.data
        out = {"broadcast": self.batch(h.lookup(params, self.rows(idx), self.rows(mask),
                                                batch_size=bd))}
        pooled, dropped = h.lookup(params, self.rows(idx), self.rows(mask), batch_size=bd,
                                   combiner="mean", routed=True, return_stats=True)
        out["routed_mean"], out["routed_dropped"] = self.batch(pooled), dropped
        return out

    def model(self, policy, hybrid=True):
        m = DLRM(mixed_config(tcfg), ShardingPolicy(policy), hybrid=hybrid, mesh=self.mesh,
                 generator=torch.Generator(device=self.dev).manual_seed(0))
        coll = m.collection
        if hybrid:
            emb = {key: getattr(coll, key).fused_host_array(
                       [self.inp[f"mtable{i}"] for i in getattr(coll, f"{key}_ids")])
                   for key in ("small", "big")}
        else:
            emb = coll.fused_host_array(host_tables(self.inp, "mtable", MIXED_ROWS))
        params_from_jax({"emb": emb, **mlp_params(self.inp)}, m)
        return m

    def model_state(self, m, acc=None):
        coll = m.collection
        out = {}
        if not m.hybrid:
            out["emb"] = coll.gather_storage(m.emb.detach())
        for key in ("small", "big") if m.hybrid else ():
            sub = getattr(coll, key)
            out[f"emb_{key}"] = sub.gather_storage(getattr(m, f"emb_{key}"))
            out[f"acc_{key}"] = sub.gather_accumulator(acc[key])
        for name in ("bot", "top"):
            for j, lin in enumerate(getattr(m, name)):
                out[f"{name}{j}_w"] = lin.weight.detach().T
                out[f"{name}{j}_b"] = lin.bias.detach()
        return out

    def step_batch(self, s):
        inp = self.inp
        return (self.rows(inp[f"mdense{s}"], 0), self.rows(inp[f"midx{s}"]),
                self.rows(inp[f"mmask{s}"]), self.rows(inp[f"mlabels{s}"], 0))

    def train(self, policy, optimizer, steps, routed=False, hot=False):
        m = self.model(policy)
        opt, acc = make_sparse_train_state(m, optimizer=optimizer, lr=LR)
        step = make_sparse_train_step(m, opt, lr=LR, optimizer=optimizer, routed=routed,
                                      hot_cache=hot)
        hot_ids = None
        if hot:
            sel = list(m.collection.big_ids)
            sample = np.concatenate([self.inp[f"midx{s}"][sel] for s in range(steps)], axis=1)
            hot_ids = hot_ids_from_sample(m.collection.big, sample, HOT_K)
        losses = []
        for s in range(steps):
            hc = (build_hot_cache(m.collection.big, m.emb_big, hot_ids) if hot else ())
            acc, loss = step(acc, *self.step_batch(s), *hc)
            losses.append(loss)
        return {"losses": torch.stack(losses), **self.model_state(m, acc)}

    def train_autodiff(self, policy, kind, steps):
        """``steps`` dense-autodiff steps of the mixed DLRM with every table
        in one collection under ``policy`` (all f32)."""
        m = self.model(policy, hybrid=False)
        step = make_train_step(m, make_optimizer(LR, kind))
        losses = [step(*self.step_batch(s))[0] for s in range(steps)]
        return {"losses": torch.stack(losses), **self.model_state(m)}

    def fit(self, policy):
        """``fit`` over two batches, reporting on the third every step."""
        m = self.model(policy, hybrid=False)
        reports = fit(m, [self.step_batch(s) for s in range(2)], lr=LR, test_freq=1,
                      test_batches=[self.step_batch(2)])
        rows = [[r.step, r.loss, r.accuracy, r.auc] for r in reports]
        return {"reports": torch.tensor(rows, dtype=torch.float64), **self.model_state(m)}

    def _grad(self, coll, storage, lookup, w):
        """The global storage's gradient of sum(lookup(storage) * w)."""
        storage.requires_grad_(True)
        (lookup(storage) * w).sum().backward()
        return {"grad": coll.gather_storage(storage.grad)}

    def grad(self, policy, combiner):
        c, fused = self.loaded(policy)
        return self._grad(c, fused, lambda f: c.lookup(
            f, self.rows(self.inp["idx"]), self.rows(self.inp["mask"]),
            batch_size=BATCH // self.mesh.data, combiner=combiner), self.rows(self.inp["g"], 0))

    def grad_csr(self, policy, combiner, data_sharded=False, routed=False):
        c, fused = self.loaded(policy)
        if data_sharded:
            q, w = self.csr_window(), self.rows(self.inp["g"], 0)
        else:
            q, w = (self.t(self.inp["cidx"]), self.t(self.inp["coff"])), self.t(self.inp["g"])
        return self._grad(c, fused, lambda f: c.lookup_csr(
            f, *q, combiner=combiner, data_sharded=data_sharded, routed=routed), w)

    def grad_routed(self, policy):
        c, fused = self.loaded(policy)
        return self._grad(c, fused, lambda f: c.lookup_routed(
            f, self.rows(self.inp["zidx"]), self.rows(self.inp["zmask"]),
            batch_size=BATCH // self.mesh.data), self.rows(self.inp["g"], 0))

    def grad_hot(self, policy):
        """The gradients of sum(lookup_routed * w) with a hot cache, w.r.t.
        the storage and the cache's rows (each the same on every process)."""
        c, fused = self.loaded(policy)
        ids, rows = build_hot_cache(c, fused, hot_ids_from_sample(c, self.inp["zidx"], HOT_K))
        hot = rows.clone().requires_grad_(True)
        out = self._grad(c, fused, lambda f: c.lookup_routed(
            f, self.rows(self.inp["zidx"]), self.rows(self.inp["zmask"]),
            batch_size=BATCH // self.mesh.data, hot_cache=(ids, hot), capacity_factor=1.0),
            self.rows(self.inp["g"], 0))
        return {**out, "hot_grad": hot.grad}

    def grad_hybrid(self):
        h, params = self.hybrid("row")
        for v in params.values():
            v.requires_grad_(True)
        out = h.lookup(params, self.rows(self.inp["midx0"]), self.rows(self.inp["mmask0"]),
                       batch_size=BATCH // self.mesh.data)
        (out * self.rows(self.inp["mg"], 0)).sum().backward()
        return {key: getattr(h, key).gather_storage(params[key].grad)
                for key in ("small", "big")}

    def guard(self, which):
        """The error a refused call raises, as 'Type: message'."""
        c, fused = self.loaded("column" if which in ("routed_column", "csr_update_column")
                               else "replicate" if which == "routed_update_replicate"
                               else "row_hash")
        q = self.rows(self.inp["idx"]), self.rows(self.inp["mask"])
        bd = BATCH // self.mesh.data
        calls = {
            "routed_column": lambda: c.lookup_routed(fused, *q, batch_size=bd),
            "routed_max": lambda: c.lookup_routed(fused, *q, batch_size=bd, combiner="max"),
            "stats_unrouted": lambda: c.lookup_csr(fused, self.t(self.inp["cidx"]),
                                                   self.t(self.inp["coff"]), return_stats=True),
            "routed_update_replicate": lambda: sparse_update(
                c, fused, init_accumulator(c), *q, self.rows(self.inp["g"], 0), lr=0.1,
                routed=True),
            "csr_update_column": lambda: sparse_update_csr(
                c, fused, init_accumulator(c), self.t(self.inp["cidx"]),
                self.t(self.inp["coff"]), self.t(self.inp["g"]), lr=0.1),
            "hot_unrouted": lambda: make_sparse_train_step(self.model("row_hash"), None,
                                                           hot_cache=True),
            "step_args": lambda: self._hot_step_without_cache(),
            "grad_rowshard_max": lambda: c.lookup(fused.clone().requires_grad_(True), *q,
                                                  batch_size=bd, combiner="max"),
        }
        try:
            calls[which]()
        except Exception as e:  # noqa: BLE001 -- the error is the result
            return {"error_text": np.frombuffer(f"{type(e).__name__}: {e}".encode(), np.uint8)}
        raise AssertionError(f"guard {which}: nothing raised")

    def _hot_step_without_cache(self):
        m = self.model("row_hash")
        opt, acc = make_sparse_train_state(m, lr=LR)
        step = make_sparse_train_step(m, opt, lr=LR, routed=True, hot_cache=True)
        step(acc, *self.step_batch(0))


    def cases(self):
        """(name, thunk) of every case, in the same order on every rank."""
        out = []
        for p in POLICIES:
            for comb in ("sum", "mean", "max"):
                out.append((f"lookup-{p}-{comb}", lambda p=p, c=comb: self.lookup(p, c)))
                out.append((f"csr-{p}-{comb}", lambda p=p, c=comb: self.csr(p, c)))
            out.append((f"csr_ds-{p}-mean", lambda p=p: self.csr_ds(p, "mean")))
            for opt in ("sgd", "row_adagrad"):
                out.append((f"update-{p}-{opt}", lambda p=p, o=opt: self.update(p, o)))
            if p != "column":
                out.append((f"update_csr-{p}", lambda p=p: self.update_csr(p)))
            out.append((f"train-{p}", lambda p=p: self.train(p, "sgd", 1)))
        for p in ROWISH:
            for comb in ("sum", "mean"):
                out.append((f"routed-{p}-{comb}", lambda p=p, c=comb: self.routed(p, c)))
                out.append((f"csr_routed-{p}-{comb}",
                            lambda p=p, c=comb: self.csr_routed(p, c)))
            out.append((f"routed_lowcf-{p}", lambda p=p: self.routed(p, "sum", cf=1.0)))
            out.append((f"csr_routed_ds-{p}",
                        lambda p=p: self.csr_routed(p, "sum", data_sharded=True, cf=1.0)))
            out.append((f"hot-{p}", lambda p=p: self.hot(p)))
            out.append((f"update_routed-{p}",
                        lambda p=p: self.update(p, "row_adagrad", routed=True, zipf=True)))
            out.append((f"update_routed_lowcf-{p}",
                        lambda p=p: self.update(p, "sgd", routed=True, cf=1.0, zipf=True)))
        out.append(("update_csr_ds-row_hash", lambda: self.update_csr("row_hash", True)))
        out.append(("update_csr_routed_ds-row",
                    lambda: self.update_csr("row", True, routed=True)))
        out.append(("hybrid_lookups", self.hybrid_lookups))
        out.append(("train_routed_trace", lambda: self.train(
            "row_hash", "row_adagrad", TRAIN_STEPS, routed=True)))
        out.append(("train_hot", lambda: self.train(
            "row_hash", "row_adagrad", TRAIN_STEPS, routed=True, hot=True)))
        for p in POLICIES:
            out.append((f"grad-{p}-sum", lambda p=p: self.grad(p, "sum")))
            out.append((f"grad_csr-{p}-sum", lambda p=p: self.grad_csr(p, "sum")))
            out.append((f"train_autodiff-{p}", lambda p=p: self.train_autodiff(p, "sgd", 1)))
        out.append(("grad-row_hash-mean", lambda: self.grad("row_hash", "mean")))
        out.append(("grad_csr_ds-row_hash-mean",
                    lambda: self.grad_csr("row_hash", "mean", data_sharded=True)))
        for p in ("replicate", "column"):
            out.append((f"grad-{p}-max", lambda p=p: self.grad(p, "max")))
        for p in ROWISH:
            out.append((f"grad_routed-{p}", lambda p=p: self.grad_routed(p)))
        out.append(("grad_csr_routed_ds-row_hash", lambda: self.grad_csr(
            "row_hash", "sum", data_sharded=True, routed=True)))
        out.append(("grad_hot-row_hash", lambda: self.grad_hot("row_hash")))
        out.append(("grad_hybrid", self.grad_hybrid))
        out.append(("train_autodiff_trace", lambda: self.train_autodiff(
            "row_hash", "adagrad", TRAIN_STEPS)))
        out.append(("fit-row_hash", lambda: self.fit("row_hash")))
        for g in ("routed_column", "routed_max", "stats_unrouted", "routed_update_replicate",
                  "csr_update_column", "hot_unrouted", "step_args", "grad_rowshard_max"):
            out.append((f"guard-{g}", lambda g=g: self.guard(g)))
        return out

    def run(self, only=None) -> dict[str, np.ndarray]:
        results = {}
        for name, fn in self.cases():
            if only is not None and name not in only:
                continue
            try:
                for key, val in fn().items():
                    val = val.detach().cpu() if isinstance(val, torch.Tensor) else val
                    results[f"{name}/{key}"] = np.asarray(val)
            except Exception:  # noqa: BLE001 -- recorded for the case's test
                results[f"{name}/error"] = np.frombuffer(traceback.format_exc().encode(),
                                                         np.uint8)
        return results


class Int8Battery(Battery):
    """The int8 capacity mode's cases, in both scale modes: the int8
    collection's broadcast, data-sharded and routed lookups (with and
    without the hot-row cache, whose rows are compared too), and the
    ROW_HASH hybrid DLRM quantized by ``quantize_dlrm_embeddings`` and
    served broadcast and routed with a hot cache."""

    def qloaded(self, policy, mode):
        c = QuantizedEmbeddingCollection.create(tables(tcfg, ROWS), ShardingPolicy(policy),
                                                scale_mode=mode, mesh=self.mesh)
        return c, c.quantize_tables(host_tables(self.inp, "table", ROWS))

    def q_lookup(self, policy, mode, combiner):
        c, params = self.qloaded(policy, mode)
        out = c.lookup(params, self.rows(self.inp["idx"]), self.rows(self.inp["mask"]),
                       batch_size=BATCH // self.mesh.data, combiner=combiner)
        return {"out": self.batch(out)}

    def q_csr_ds(self, policy, mode):
        c, params = self.qloaded(policy, mode)
        out = c.lookup_csr(params, *self.csr_window(), combiner="mean", data_sharded=True)
        return {"out": self.batch(out)}

    def q_routed(self, policy, mode, hot=False):
        c, params = self.qloaded(policy, mode)
        res, cache, cf = {}, None, None
        if hot:
            cache = build_hot_cache(c, params, hot_ids_from_sample(c, self.inp["zidx"], HOT_K))
            res["hot_rows"], cf = cache[1], 1.0
        out, dropped = c.lookup_routed(
            params, self.rows(self.inp["zidx"]), self.rows(self.inp["zmask"]),
            batch_size=BATCH // self.mesh.data, capacity_factor=cf, hot_cache=cache,
            return_stats=True)
        return {**res, "out": self.batch(out), "dropped": dropped}

    def q_csr_routed(self, policy, mode, data_sharded=False):
        c, params = self.qloaded(policy, mode)
        q = (self.csr_window() if data_sharded
             else (self.t(self.inp["cidx"]), self.t(self.inp["coff"])))
        out, dropped = c.lookup_csr(params, *q, data_sharded=data_sharded, routed=True,
                                    capacity_factor=1.0 if data_sharded else None,
                                    return_stats=True)
        return {"out": self.batch(out) if data_sharded else out, "dropped": dropped}

    def q_serve(self, mode):
        m = self.model("row_hash")
        coll, emb = quantize_dlrm_embeddings(m, scale_mode=mode)
        dense, idx, mask, _ = self.step_batch(0)
        bd = BATCH // self.mesh.data
        sample = self.inp["midx0"][list(coll.big_ids)]
        cache = build_hot_cache(coll.big, emb["big"], hot_ids_from_sample(coll.big, sample,
                                                                          HOT_K))
        with torch.no_grad():
            broadcast = m.apply_from_pooled(dense, coll.lookup(emb, idx, mask, batch_size=bd))
            routed = m.apply_from_pooled(dense, coll.lookup(
                emb, idx, mask, batch_size=bd, routed=True, hot_cache=cache))
        big = {k: v if k == "tscale" else self.mesh.all_gather(v, MODEL_AXIS, 0)
               for k, v in emb["big"].items()}  # the global params, to compare bitwise
        return {"broadcast": self.batch(broadcast), "routed_hot": self.batch(routed),
                "hot_rows": cache[1], **{f"big_{k}": v for k, v in big.items()}}

    def cases(self):
        out = []
        for mode in ("table", "row"):
            out += [
                (f"q_lookup-row_hash-{mode}-max",
                 lambda m=mode: self.q_lookup("row_hash", m, "max")),
                (f"q_lookup-table_wise-{mode}-mean",
                 lambda m=mode: self.q_lookup("table_wise", m, "mean")),
                (f"q_csr_ds-row-{mode}", lambda m=mode: self.q_csr_ds("row", m)),
                (f"q_routed-row-{mode}", lambda m=mode: self.q_routed("row", m)),
                (f"q_routed-row_hash-{mode}", lambda m=mode: self.q_routed("row_hash", m)),
                (f"q_hot-row_hash-{mode}", lambda m=mode: self.q_routed("row_hash", m, True)),
                (f"q_csr_routed-row_hash-{mode}",
                 lambda m=mode: self.q_csr_routed("row_hash", m)),
                (f"q_csr_routed_ds-table_wise-{mode}",
                 lambda m=mode: self.q_csr_routed("table_wise", m, True)),
                (f"q_serve-{mode}", lambda m=mode: self.q_serve(m)),
            ]
        return out


BATTERIES = {"main": Battery, "int8": Int8Battery}


def case_names(group: str = "main") -> list[str]:
    """The case names of a battery group, in order (no process group
    needed)."""
    class _Stub:  # the cases are listed without running them
        data = 1
        device = torch.device("cpu")
    return [name for name, _ in BATTERIES[group](_Stub(), {}).cases()]


def main(argv) -> int:
    if len(argv) not in (8, 9) or argv[7] not in ("cpu", "cuda"):
        print("usage: python -m pim_embedding_lookup_tpu_torch.mesh_battery RANK WORLD DATA "
              "MODEL INIT_FILE IN_NPZ OUT_DIR cpu|cuda [main|int8]", file=sys.stderr)
        return 2
    rank, world, data, model = map(int, argv[:4])
    init_file, in_npz, out_dir, device = argv[4:8]
    group = argv[8] if len(argv) > 8 else "main"
    torch.set_num_threads(1)
    dev = init_distributed(rank, world, f"file://{init_file}",
                           device if device == "cpu" else None)
    mesh = make_mesh(data=data, model=model, device=dev)
    inp = dict(np.load(in_npz))
    results = BATTERIES[group](mesh, inp).run()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: {len(results)} arrays, "
          f"{sum(k.endswith('/error') for k in results)} errors", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
