"""The query-surface battery on a (data, model) mesh, at toy sizes: one
process per device, every rank running the same cases.

Cases, each on inputs drawn with numpy (``make_inputs``) and shipped in an
``.npz``, so that another implementation computes the same cases from the
same arrays:

  fuzz-<n>       the seeded query-surface fuzz: from seed 1000 + n, in the
                 JAX suite's draw order (tests/test_surface_matrix.py), a
                 policy, packed or not, f32 or int8 (with its scale mode), a
                 combiner, routed or not, data-sharded or not, dim 8, 16 or
                 32, ragged bags; ``lookup_csr`` on the mesh (a planner's
                 refusal is the result, as 'Type: message')
  bf16-<policy>  bf16 storage: the dense-wire lookup broadcast and routed
  ckpt-<mode>    int8 params of a ROW_HASH ``QuantizedEmbeddingCollection``
                 saved by ``utils.checkpoint`` (one file per model shard),
                 restored into a fresh template; the same checkpoint
                 restored into a ROW collection's template and into the
                 other scale mode's, both refused

Each rank writes ``<out>/rank<r>.npz``: lookups gathered to the global
batch, the checkpoint cases' arrays as this rank's shard.  A case that
raises records its traceback as ``<case>/error``.

    python -m pim_embedding_lookup_tpu_torch.surface_battery \\
        RANK WORLD DATA MODEL INIT_FILE IN_NPZ OUT_DIR cpu|cuda

The process group is joined through ``INIT_FILE`` (a file store): gloo on
the CPU, NCCL on the card.  The checkpoints go to ``OUT_DIR``, which every
rank must see.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import mesh_battery
from .config import ShardingPolicy, TableConfig
from .ops.ragged import csr_to_dense, shard_csr
from .parallel.collection import EmbeddingCollection
from .parallel.mesh import init_distributed, make_mesh
from .parallel.quantized_collection import QuantizedEmbeddingCollection
from .utils import checkpoint

FUZZ_SEED = 1000
FUZZ_CASES = 60
ROWISH = ("row", "row_hash", "table_wise")
ALL_POLICIES = ROWISH + ("replicate", "column")  # the JAX suite's order
BF16_ROWS, BF16_BATCH, BF16_POOLING, BF16_SEED = (500, 3000), 16, 3, 44
BF16_POLICIES = ("row_hash", "row", "table_wise")
CKPT_ROWS, CKPT_SEED = (100, 1000, 37, 4000), 10
SCALE_MODES = ("table", "row")


def draw_fuzz(case: int, nd: int, *, bf16: bool = False) -> tuple[dict, dict]:
    """Fuzz case ``case``: (spec, arrays).  Drawn from seed 1000 + case in
    the JAX suite's order, with data-sharded windows for a data axis of
    ``nd``.  ``bf16``: one more draw, after all of those, turns half of the
    float cases into bf16 storage (the JAX suite draws no bf16)."""
    rng = np.random.default_rng(FUZZ_SEED + case)
    t = int(rng.integers(2, 5))
    dim = int(rng.choice([8, 16, 32]))
    rows = [int(rng.integers(16, 3000)) for _ in range(t)]
    int8 = bool(rng.random() < 0.4)
    packed = bool(rng.random() < 0.5)
    policy = (ALL_POLICIES[int(rng.integers(len(ALL_POLICIES)))] if not int8
              else ROWISH[int(rng.integers(len(ROWISH)))])
    routed = bool(rng.random() < 0.5) and policy in ROWISH
    combiner = ["sum", "mean", "max"][int(rng.integers(3))]
    if routed and combiner == "max":
        combiner = "mean"
    data_sharded = bool(rng.random() < 0.5)
    b = int(rng.choice([8, 16]))
    arrays = {f"table{i}": rng.standard_normal((n, dim)).astype(np.float32)
              for i, n in enumerate(rows)}
    scale_mode = None
    if int8:
        scale_mode = "table" if rng.random() < 0.5 else "row"
    max_len = int(rng.integers(2, 7))
    bags = [[rng.integers(0, n, size=rng.integers(0, max_len)).astype(int).tolist()
             for _ in range(b)] for n in rows]
    storage = "int8" if int8 else "f32"
    if bf16 and not int8 and rng.random() < 0.5:
        storage = "bf16"
    shards = nd if data_sharded else 1
    arrays["idx"], arrays["off"] = shard_csr(bags, shards, max_len * (b // shards))
    spec = dict(case=case, rows=rows, dim=dim, storage=storage, scale_mode=scale_mode,
                packed=packed, policy=policy, routed=routed, combiner=combiner,
                data_sharded=data_sharded, batch=b, max_len=max_len)
    return spec, arrays


def draw_bf16() -> dict:
    """The bf16 cases' tables, dense-wire ids [T, B*L] and mask (< 0.8)."""
    rng = np.random.default_rng(BF16_SEED)
    out = {f"table{i}": rng.standard_normal((n, 16)).astype(np.float32)
           for i, n in enumerate(BF16_ROWS)}
    n = BF16_BATCH * BF16_POOLING
    out["idx"] = np.stack([rng.integers(0, r, n) for r in BF16_ROWS]).astype(np.int32)
    out["mask"] = rng.random((len(BF16_ROWS), n)) < 0.8
    return out


def draw_ckpt() -> dict:
    rng = np.random.default_rng(CKPT_SEED)
    return {f"table{i}": rng.standard_normal((n, 16)).astype(np.float32)
            for i, n in enumerate(CKPT_ROWS)}


def make_inputs(nd: int) -> dict[str, np.ndarray]:
    """Every input of the battery for a data axis of ``nd``, keyed
    ``<case>/<name>``; a fuzz case's spec is its JSON as uint8."""
    inp = {}
    for case in range(FUZZ_CASES):
        spec, arrays = draw_fuzz(case, nd)
        inp[f"fuzz-{case}/spec"] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
        inp.update({f"fuzz-{case}/{k}": v for k, v in arrays.items()})
    inp.update({f"bf16/{k}": v for k, v in draw_bf16().items()})
    inp.update({f"ckpt/{k}": v for k, v in draw_ckpt().items()})
    return inp


def tables(rows, dim: int) -> tuple:
    return tuple(TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows))


def build(spec: dict, host_tables, policy: str, *, mesh=None, device=None):
    """(collection, params) of a fuzz case's tables under ``policy``."""
    tabs, pol = tables(spec["rows"], spec["dim"]), ShardingPolicy(policy)
    if spec["storage"] == "int8":
        coll = QuantizedEmbeddingCollection.create(
            tabs, pol, packed=spec["packed"], scale_mode=spec["scale_mode"], device=device,
            mesh=mesh)
        return coll, coll.quantize_tables(host_tables)
    coll = EmbeddingCollection.create(tabs, pol, packed=spec["packed"], device=device,
                                      mesh=mesh)
    params = coll.device_put_tables(host_tables)
    return coll, params.to(torch.bfloat16) if spec["storage"] == "bf16" else params


def dense_query(idx: torch.Tensor, off: torch.Tensor, max_len: int):
    """A CSR query [T, C], [T, B+1] on the dense wire: [T, B*max_len] ids
    and mask."""
    parts = [csr_to_dense(i, o, max_len) for i, o in zip(idx, off)]
    return (torch.stack([p[0].reshape(-1) for p in parts]),
            torch.stack([p[1].reshape(-1) for p in parts]))


def lookup(coll, params, spec: dict, idx, off, *, wire: str = "csr", routed=None):
    """A fuzz case's lookup on ``wire`` ("csr": ``lookup_csr``, data-sharded
    as the case draws it; "dense": the same bags through ``csr_to_dense``
    and ``lookup``/``lookup_routed``, the whole batch): (pooled [B, T, D],
    drop count or None).  ``routed`` defaults to the case's."""
    routed = spec["routed"] if routed is None else routed
    comb = spec["combiner"]
    if wire == "csr":
        ds = spec["data_sharded"]
        if routed:
            return coll.lookup_csr(params, idx, off, combiner=comb, data_sharded=ds,
                                   routed=True, return_stats=True)
        return coll.lookup_csr(params, idx, off, combiner=comb, data_sharded=ds), None
    didx, mask = dense_query(idx, off, spec["max_len"])
    if routed:
        return coll.lookup_routed(params, didx, mask, batch_size=spec["batch"],
                                  combiner=comb, return_stats=True)
    return coll.lookup(params, didx, mask, batch_size=spec["batch"], combiner=comb), None


def error_text(exc: BaseException, path: str | None = None) -> np.ndarray:
    """'Type: message' as uint8, ``path`` (which differs between runs)
    written as <path>."""
    text = f"{type(exc).__name__}: {exc}"
    return np.frombuffer((text.replace(path, "<path>") if path else text).encode(), np.uint8)


class Battery(mesh_battery.Battery):
    """The cases on one rank (``run`` returns {case/key: array}); the
    checkpoints go to ``out_dir``."""

    def __init__(self, mesh, inp, out_dir):
        super().__init__(mesh, inp)
        self.out_dir = Path(out_dir)

    def host(self, case, n):
        return [self.inp[f"{case}/table{i}"] for i in range(n)]

    def fuzz(self, case):
        spec = json.loads(bytes(self.inp[f"{case}/spec"]).decode())
        try:
            coll, params = build(spec, self.host(case, len(spec["rows"])), spec["policy"],
                                 mesh=self.mesh)
        except ValueError as e:  # a planner's refusal is the case's result
            return {"error_text": error_text(e)}
        idx, off = self.t(self.inp[f"{case}/idx"]), self.t(self.inp[f"{case}/off"])
        if spec["data_sharded"]:
            idx, off = self.mesh.csr_window(idx, off)
        out, dropped = lookup(coll, params, spec, idx, off)
        res = {"out": self.batch(out) if spec["data_sharded"] else out}
        return res if dropped is None else {**res, "dropped": dropped}

    def bf16(self, policy):
        coll = EmbeddingCollection.create(tables(BF16_ROWS, 16), ShardingPolicy(policy),
                                          mesh=self.mesh)
        fused = coll.device_put_tables(self.host("bf16", len(BF16_ROWS))).to(torch.bfloat16)
        idx, mask = self.rows(self.inp["bf16/idx"]), self.rows(self.inp["bf16/mask"])
        bd = BF16_BATCH // self.mesh.data
        routed, dropped = coll.lookup_routed(fused, idx, mask, batch_size=bd,
                                             return_stats=True)
        broadcast = coll.lookup(fused, idx, mask, batch_size=bd)
        return {"routed": self.batch(routed), "broadcast": self.batch(broadcast),
                "dropped": dropped}

    def qcoll(self, policy, mode):
        return QuantizedEmbeddingCollection.create(
            tables(CKPT_ROWS, 16), ShardingPolicy(policy), packed=True, scale_mode=mode,
            mesh=self.mesh)

    def ckpt(self, mode):
        """Save, then restore into a template drawn from another seed: the
        saved and the restored params of this rank's shard; then the two
        refused restores (their errors, and the templates unchanged)."""
        coll = self.qcoll("row_hash", mode)
        params = coll.quantize_tables(self.host("ckpt", len(CKPT_ROWS)))
        path = str(self.out_dir / f"ckpt_{mode}")
        checkpoint.save(path, params, meta=checkpoint.collection_meta(coll), mesh=self.mesh)
        gen = torch.Generator(device=self.dev).manual_seed(1 + self.mesh.rank)
        template = coll.init(gen)
        restored = checkpoint.restore(path, template, mesh=self.mesh,
                                      expect_meta=checkpoint.collection_meta(coll))
        out = {f"saved_{k}": v for k, v in params.items()}
        out.update({f"restored_{k}": v for k, v in restored.items()})
        out["restored_in_place"] = np.asarray(
            all(restored[k] is template[k] for k in template))
        other_mode = SCALE_MODES[1 - SCALE_MODES.index(mode)]
        for name, other in (("layout", self.qcoll("row", mode)),
                            ("scale_mode", self.qcoll("row_hash", other_mode))):
            template = other.init(gen)
            before = {k: v.clone() for k, v in template.items()}
            try:
                checkpoint.restore(path, template, mesh=self.mesh,
                                   expect_meta=checkpoint.collection_meta(other))
            except ValueError as e:
                out[f"{name}_error_text"] = error_text(e, path)
            out[f"{name}_template_kept"] = np.asarray(
                all(torch.equal(before[k], template[k]) for k in template))
        return out

    def cases(self):
        """(name, thunk) of every case, in the same order on every rank."""
        out = [(k[:-len("/spec")], lambda c=k[:-len("/spec")]: self.fuzz(c))
               for k in self.inp if k.startswith("fuzz-") and k.endswith("/spec")]
        out += [(f"bf16-{p}", lambda p=p: self.bf16(p)) for p in BF16_POLICIES]
        out += [(f"ckpt-{m}", lambda m=m: self.ckpt(m)) for m in SCALE_MODES]
        return out


def main(argv) -> int:
    if len(argv) != 8 or argv[7] not in ("cpu", "cuda"):
        print("usage: python -m pim_embedding_lookup_tpu_torch.surface_battery RANK WORLD "
              "DATA MODEL INIT_FILE IN_NPZ OUT_DIR cpu|cuda", file=sys.stderr)
        return 2
    rank, world, data, model = map(int, argv[:4])
    init_file, in_npz, out_dir, device = argv[4:8]
    torch.set_num_threads(1)
    dev = init_distributed(rank, world, f"file://{init_file}",
                           device if device == "cpu" else None)
    mesh = make_mesh(data=data, model=model, device=dev)
    results = Battery(mesh, dict(np.load(in_npz)), out_dir).run()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: {len(results)} arrays, "
          f"{sum(k.endswith('/error') for k in results)} errors", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
