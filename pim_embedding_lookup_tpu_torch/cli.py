"""Command-line entry point: train, evaluate and checkpoint a DLRM; bench
the lookup; sweep the r.sh grids.

The counterpart of ``pim_embedding_lookup_tpu.cli``, with its three
subcommands and every flag and default, plus ``--device``.  ``train``
follows the dlrm CLI's flag contract (``--arch-*``, ``--mini-batch-size``,
``--num-indices-per-lookup``, ``--inference-only``, ``--nepochs``,
``--test-freq``, ``--save-model``, ``--load-model``, ``--print-time``);
``bench`` is the port's lookup bench (``bench.py``, its flags); ``sweep``
runs an r.sh grid through it, one JSON record a point:

    python -m pim_embedding_lookup_tpu_torch.cli train --data-generation=random ...
    python -m pim_embedding_lookup_tpu_torch.cli train --device=cpu ...
    torchrun --nproc-per-node 4 -m pim_embedding_lookup_tpu_torch.cli train \\
        --mesh-data=2 --mesh-model=2 --sharding=row_hash ...
    python -m pim_embedding_lookup_tpu_torch.cli bench --config random --no-baseline
    python -m pim_embedding_lookup_tpu_torch.cli sweep --grid table-size

It runs on CUDA unless ``--device`` names another device.  One process
drives one device: under a launcher's environment (``WORLD_SIZE`` set, as
torchrun sets it) every process joins the job (``parallel.multihost``),
the (data, model) mesh is ``--mesh-data`` x ``--mesh-model`` (0: the
processes left over), and each process feeds its data row's slice of every
batch; only rank 0 prints, and the reports cover the global batch.  On a
single process a policy other than AUTO or REPLICATE runs on a mesh of
one.  ``bench`` runs under torchrun as ``bench.py`` says; ``sweep`` runs
in one process on one device.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time


def _add_arch_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arch-sparse-feature-size", type=int, default=16)
    p.add_argument("--arch-embedding-size", type=str, default="",
                   help="dash-separated rows per table, e.g. 1000-1000-1000")
    p.add_argument("--arch-mlp-bot", type=str, default="13-512-256-64-16")
    p.add_argument("--arch-mlp-top", type=str, default="512-256-1")
    p.add_argument("--sharding", type=str, default="auto",
                   choices=["auto", "replicate", "row", "row_hash", "column",
                            "table_wise"])
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=0, help="0 = all remaining")


def _build_config(args):
    from .config import DLRMConfig, TableConfig, kaggle_config

    dim = args.arch_sparse_feature_size
    if getattr(args, "data_set", "") == "kaggle" and not args.arch_embedding_size:
        return kaggle_config(dim)
    rows = [int(r) for r in args.arch_embedding_size.split("-") if r] or [1000] * 8
    bot = [int(x) for x in args.arch_mlp_bot.split("-")]
    top = [int(x) for x in args.arch_mlp_top.split("-")]
    tables = tuple(
        TableConfig(num_rows=r, dim=dim, name=f"t{i}") for i, r in enumerate(rows)
    )
    return DLRMConfig(
        dense_dim=bot[0], mlp_bot=tuple(bot[1:]), mlp_top=tuple(top), tables=tables
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_mesh(args):
    """(device, mesh or None) of this process (module docstring)."""
    import torch.distributed as dist

    from .config import ShardingPolicy
    from .device import resolve_device
    from .parallel import multihost
    from .parallel.mesh import make_mesh

    dev = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        dev = multihost.initialize(device=None if args.device == "cuda" else dev)
        world = dist.get_world_size()
        model = args.mesh_model or max(1, world // args.mesh_data)
        if args.mesh_data * model != world:
            sys.exit(f"mesh {args.mesh_data}x{model} != {world} processes")
        return dev, make_mesh(data=args.mesh_data, model=model, device=dev)
    if args.mesh_data != 1 or args.mesh_model > 1:
        sys.exit(f"a {args.mesh_data}x{args.mesh_model} mesh runs one process per device: "
                 "start them with torchrun")
    if ShardingPolicy(args.sharding) in (ShardingPolicy.AUTO, ShardingPolicy.REPLICATE):
        return dev, None
    dev = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
    return dev, make_mesh(data=1, model=1, device=dev)


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    _add_arch_flags(p)
    p.add_argument("--data-generation", default="random", choices=["random", "dataset"])
    p.add_argument("--data-set", default="", choices=["", "kaggle"])
    p.add_argument("--processed-data-file", default="")
    p.add_argument("--raw-data-file", default="")
    p.add_argument("--max-rows", type=int, default=0, help="cap dataset rows")
    p.add_argument("--mini-batch-size", type=int, default=188)
    p.add_argument("--num-indices-per-lookup", type=int, default=1)
    p.add_argument("--num-batches", type=int, default=100)
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--loss-function", default="bce", choices=["bce"])
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adagrad"])
    p.add_argument(
        "--embedding-update", default="sparse", choices=["sparse", "dense"],
        help="sparse = scatter the update into the tables (no dense table "
             "gradient); dense = autodiff through the lookup",
    )
    p.add_argument("--inference-only", action="store_true")
    p.add_argument("--test-freq", type=int, default=0)
    p.add_argument("--save-model", default="")
    p.add_argument("--load-model", default="")
    p.add_argument("--print-time", action="store_true")
    p.add_argument("--hybrid", action="store_true",
                   help="hybrid embedding collection: small tables pooled in bf16 "
                        "(on the CSR wire as one-hot matmuls), lane-packed gather "
                        "for big tables")
    p.add_argument("--routed", action="store_true",
                   help="all-to-all id routing for the sharded lookup and "
                        "scatter update (needs a rowish sharding and >1 process)")
    p.add_argument("--hot-k", type=int, default=0,
                   help="replicate the K hottest rows and serve them "
                        "locally in routed lookups (parallel/hotcache.py)")
    p.add_argument("--hot-rebuild-every", type=int, default=50,
                   help="refresh the (stale-after-update) hot-row replica "
                        "every N train steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu; under torchrun, cuda is "
                        "card LOCAL_RANK")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .config import ShardingPolicy
    from .data.criteo import CriteoKaggle
    from .data.prefetch import device_prefetch
    from .data.synthetic import SyntheticDLRMBatches
    from .models import DLRM, binary_accuracy, fit, make_eval_step, roc_auc
    from .parallel.mesh import DATA_AXIS
    from .utils import checkpoint
    from .utils.profiling import PhaseTimer

    owns_group = not dist.is_initialized()  # a caller's process group outlives this run
    dev, mesh = _make_mesh(args)
    primary = not dist.is_initialized() or dist.get_rank() == 0

    def say(*a):
        if primary:
            print(*a, flush=True)

    test_batches = None
    if args.data_generation == "dataset" and args.data_set == "kaggle":
        path = args.processed_data_file or args.raw_data_file
        if not path:
            sys.exit("--processed-data-file or --raw-data-file required for kaggle")
        max_rows = args.max_rows or None
        if path.endswith(".npz"):
            ds = CriteoKaggle.load_npz(path, max_rows)
        else:
            ds = CriteoKaggle.parse_raw(path, max_rows)
        config = ds.dlrm_config(args.arch_sparse_feature_size)
        train_ds, test_ds = ds.split()
        batches = list(train_ds.batches(args.mini_batch_size, shuffle=True,
                                        seed=args.seed))
        test_batches = list(test_ds.batches(args.mini_batch_size))
    else:
        config = _build_config(args)
        batches = list(
            SyntheticDLRMBatches(
                config,
                batch_size=args.mini_batch_size,
                indices_per_lookup=args.num_indices_per_lookup,
                num_batches=args.num_batches,
                seed=args.seed,
            )
        )

    def local(batch):
        """This process's data row's slice of a global batch."""
        if mesh is None:
            return batch
        dense, idx, mask, labels = batch
        return (mesh.data_slice(dense, 0), mesh.data_slice(idx, 1),
                mesh.data_slice(mask, 1), mesh.data_slice(labels, 0))

    def as_dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    model = DLRM(config, ShardingPolicy(args.sharding), hybrid=args.hybrid, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(args.seed), mesh=mesh)
    params = checkpoint.model_params(model)
    expect_meta = {"collection": checkpoint.collection_meta(model.collection)}
    load_full = False  # full train state (emb+acc+opt_state+step) on disk?
    if args.load_model:
        saved = checkpoint.saved_meta(args.load_model)
        load_full = bool(saved and saved.get("state") == "full")
        resume_full = (load_full and not args.inference_only
                       and args.embedding_update == "sparse")
        if load_full and not resume_full:
            # a full train state read by a mode that does not resume it:
            # take its params, drop the optimizer state
            checkpoint.validate_meta(args.load_model, expect_meta)
            raw = checkpoint.restore_raw(args.load_model, mesh=mesh)
            checkpoint.pin_like({"emb": raw["emb"], **raw["dense"]}, params)
            say(f"loaded model (params of full state) from {args.load_model}")
        elif not load_full:
            checkpoint.restore(args.load_model, params, expect_meta=expect_meta, mesh=mesh)
            say(f"loaded model from {args.load_model}")

    eval_step = make_eval_step(model)

    def predict(batch):
        """Click probabilities of a global batch (gathered over the data
        axis on a mesh), on the host."""
        dense, idx, mask, _ = local(batch)
        pr = eval_step(as_dev(dense), as_dev(idx), as_dev(mask))
        if mesh is not None:
            pr = mesh.all_gather(pr.contiguous(), DATA_AXIS, 0)
        return pr.cpu().numpy()

    def report(eval_batches):
        probs = np.concatenate([predict(b) for b in eval_batches])
        labs = np.concatenate([np.asarray(b[3]) for b in eval_batches])
        return binary_accuracy(probs, labs), roc_auc(probs, labs)

    timer = PhaseTimer()
    if args.inference_only:
        probs, labs = [], []
        for batch in batches:
            with timer.phase("inference"):  # ends in the copy to the host
                probs.append(predict(batch))
            labs.append(np.asarray(batch[3]))
        probs, labs = np.concatenate(probs), np.concatenate(labs)
        say(f"accuracy={binary_accuracy(probs, labs):.4f} "
            f"auc={roc_auc(probs, labs):.4f}")
    elif args.embedding_update == "sparse":
        from .models.sparse_train import make_sparse_train_state, make_sparse_train_step

        emb_opt = "row_adagrad" if args.optimizer == "adagrad" else "sgd"
        dense_opt, acc = make_sparse_train_state(model, optimizer=emb_opt,
                                                 lr=args.learning_rate)
        routed = args.routed and mesh is not None and dist.get_world_size() > 1
        use_hot = bool(routed and args.hot_k)
        step = make_sparse_train_step(model, dense_opt, lr=args.learning_rate,
                                      optimizer=emb_opt, routed=routed, hot_cache=use_hot)

        rebuild_hot = None
        if use_hot:
            from .parallel.hotcache import build_hot_cache, hot_ids_from_sample
            from .parallel.hybrid import HybridEmbeddingCollection

            coll0 = model.collection
            hybrid0 = isinstance(coll0, HybridEmbeddingCollection)
            target = coll0.big if hybrid0 else coll0
            sel = list(coll0.big_ids) if hybrid0 else None
            sample = np.concatenate(
                [b_[1] if sel is None else b_[1][sel] for b_ in batches[:32]], axis=1)
            hot_ids = hot_ids_from_sample(target, sample, args.hot_k)

            def rebuild_hot():
                emb_now = model.emb_params()
                return build_hot_cache(target, emb_now["big"] if hybrid0 else emb_now,
                                       hot_ids)

        dense_tree = {k: params[k] for k in ("bot", "top")}
        stepno = 0
        if load_full:
            # full-state resume: tables, accumulator, dense params, dense
            # optimizer state and step, so training goes on where it stopped
            tpl = {"emb": params["emb"], "acc": acc, "dense": dense_tree,
                   "opt_state": dense_opt.state_dict(), "step": 0}
            st = checkpoint.restore(args.load_model, tpl, expect_meta=expect_meta,
                                    mesh=mesh)
            acc = st["acc"]
            dense_opt.load_state_dict(st["opt_state"])
            stepno = int(st["step"])
            say(f"resumed full train state from {args.load_model} at step {stepno}")
        t0 = time.perf_counter()
        hc = rebuild_hot() if rebuild_hot else ()
        for epoch in range(args.nepochs):
            # a background thread stages upcoming batches on the device
            # while the current step computes
            for dense_x, idx, mask, labels in device_prefetch(
                    (local(b) for b in batches), device=dev):
                with timer.phase("train_step", sync=dense_x):
                    acc, loss = step(acc, dense_x, idx, mask, labels, *hc)
                stepno += 1
                if rebuild_hot and stepno % max(1, args.hot_rebuild_every) == 0:
                    # refresh the replica from the live tables, so that hot
                    # rows drift at most hot_rebuild_every steps
                    hc = rebuild_hot()
                if args.test_freq and stepno % args.test_freq == 0:
                    accuracy, auc = report(test_batches or batches[:4])
                    say(f"step {stepno}: loss={float(loss):.4f} "
                        f"acc={accuracy:.4f} auc={auc:.4f}")
            say(f"epoch {epoch}: {time.perf_counter()-t0:.1f}s elapsed")
        if args.save_model:
            checkpoint.save(
                args.save_model,
                {"emb": params["emb"], "acc": acc, "dense": dense_tree,
                 "opt_state": dense_opt.state_dict(), "step": stepno},
                meta={**expect_meta, "state": "full"}, mesh=mesh,
            )
            say(f"saved full train state to {args.save_model}")
            args.save_model = ""  # the params-only save below is not needed
    else:
        t0 = time.perf_counter()
        for epoch in range(args.nepochs):
            fit(
                model, iter([local(b) for b in batches]),
                lr=args.learning_rate,
                optimizer_kind=args.optimizer,
                test_freq=args.test_freq,
                test_batches=[local(b) for b in (test_batches or batches[:4])],
                log_fn=lambda r: say(
                    f"step {r.step}: loss={r.loss:.4f} acc={r.accuracy:.4f} "
                    f"auc={r.auc:.4f}"),
            )
            say(f"epoch {epoch}: {time.perf_counter()-t0:.1f}s elapsed")
    if args.print_time and primary:
        timer.print_report()
    if args.save_model:
        checkpoint.save(args.save_model, params,
                        meta={**expect_meta, "state": "params"}, mesh=mesh)
        say(f"saved model to {args.save_model}")
    if owns_group and dist.is_initialized():
        dist.destroy_process_group()


def cmd_bench(argv):
    from . import bench

    bench.main(argv)


# A card's table budget is its free memory at start less this reserve: the
# largest grid point's queries, output and loop buffers take under 0.1 GB
# (the pooling grid's 26 x 2048*120 int32 ids, rotated: 51 MB); the rest
# covers cuBLAS's workspace and the allocator's rounding.
SWEEP_RESERVE_GB = 2.0
# The JAX sweep's default budget (16 GB of a v5e less queries, outputs and
# workspace): the CPU sweep's default, so that both sweeps skip alike.
CPU_SWEEP_BUDGET_GB = 13.0

SWEEP_GRIDS = {
    # r.sh:18-39: 125k..13.9M rows x 32 tables, dim 64
    "table-size": [
        dict(tables=32, rows=r, dim=64, batch=64, pooling=120)
        for r in [125_000, 250_000, 500_000, 1_000_000, 2_000_000,
                  4_000_000, 8_000_000, 13_900_000]
    ],
    # r.sh:41-66: 2..32 tables @500k rows
    "table-count": [
        dict(tables=t, rows=500_000, dim=64, batch=64, pooling=120)
        for t in [2, 4, 8, 16, 32]
    ],
    # r.sh:68-89: batch 8..100
    "batch-size": [
        dict(tables=32, rows=500_000, dim=64, batch=b, pooling=120)
        for b in [8, 16, 32, 64, 100]
    ],
    "pooling": [
        dict(tables=26, rows=500_000, dim=16, batch=2048, pooling=l)
        for l in [1, 4, 16, 32, 64, 120]
    ],
}


def cmd_sweep(argv):
    """r.sh parity sweeps (r.sh:18-89): table-size, table-count,
    batch-size, plus a pooling-factor grid (the reference's
    MAX_INDICES_PER_BATCH axis), each point timed by the lookup bench.

    The grid's top points exceed one card in f32 (13.9M x 32 x dim 64 =
    114 GB), so the sweep stores bf16 by default, switches to the int8
    collection above ``--quantized-above-gb``, and skips, with a "needs N
    chips" record, a point that does not fit the table budget even in
    int8.  Each point's tables are freed before the next is built."""
    import gc

    import torch

    from .bench import build_lookup, log, lookup_rate
    from .config import TableConfig
    from .device import resolve_device
    from .tools import common

    p = argparse.ArgumentParser(prog="sweep")
    p.add_argument("--grid", required=True, choices=list(SWEEP_GRIDS))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default="")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--no-hybrid", action="store_true")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="usable table budget on the device, GB (default: on the card "
                        f"its free memory at start less {SWEEP_RESERVE_GB} GB; on the "
                        f"CPU {CPU_SWEEP_BUDGET_GB}, the JAX sweep's default)")
    p.add_argument("--quantized-above-gb", type=float, default=None,
                   help="use the int8 collection when the dtype-sized table "
                        "exceeds this (default: the table budget)")
    common.add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    budget = args.hbm_budget_gb
    if budget is None and dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        budget = free / 1e9 - SWEEP_RESERVE_GB
        log(f"sweep: table budget {budget:.2f} GB = {free / 1e9:.2f} GB free of "
            f"{total / 1e9:.2f} GB at start, less a reserve of {SWEEP_RESERVE_GB} GB")
    elif budget is None:
        budget = CPU_SWEEP_BUDGET_GB
    itemsize = {"float32": 4, "bfloat16": 2}[args.dtype]
    quant_above = (args.quantized_above_gb if args.quantized_above_gb is not None
                   else budget)
    results = []
    for point in SWEEP_GRIDS[args.grid]:
        tables = tuple(
            TableConfig(num_rows=point["rows"], dim=point["dim"], name=f"t{i}")
            for i in range(point["tables"])
        )
        total = point["tables"] * point["rows"]
        gb = total * point["dim"] * itemsize / 1e9
        gb_int8 = total * (point["dim"] + 4) / 1e9  # +4B/row f32 scale
        quantized = gb > quant_above
        need_gb = gb_int8 if quantized else gb
        if need_gb > budget:
            rec = {**point, "skipped": "exceeds single-chip HBM",
                   "tables_gb": round(need_gb, 1),
                   "needs_chips": int(-(-need_gb // budget))}
            results.append(rec)
            print(json.dumps(rec), flush=True)
            continue
        lk = build_lookup(tables, point["batch"], point["pooling"],
                          hybrid=not args.no_hybrid, dtype=args.dtype,
                          quantized=quantized, device=dev)
        rate = lookup_rate(lk, args.iters)
        del lk  # free this point's tables before the next point's
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec = {**point, "dtype": "int8" if quantized else args.dtype,
               "tables_gb": round(need_gb, 2),
               "lookups_per_s": round(rate.lookups_per_s, 1),
               "pooled_gbps": round(rate.gbps, 2),
               "mean_us": round(rate.dt * 1e6, 1),
               "device_mean_us": (None if rate.device_dt is None
                                  else round(rate.device_dt * 1e6, 1))}
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"train": cmd_train, "bench": cmd_bench, "sweep": cmd_sweep}
    if not argv or argv[0] not in cmds:
        sys.exit(f"usage: cli.py {{{'|'.join(cmds)}}} ...")
    cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
