"""Training throughput: a loop of sparse train steps, the ids rotated on the
device each step (``tools/common.py``), timed by the host clock to a
synchronize and, on the card, by CUDA events.

The counterpart of the JAX package's ``tools/train_bench.py``, with its
flags, defaults and JSON keys, plus ``--device`` and the device keys
(``device_us_per_step``: the median over ``--iters`` event-timed runs of one
step each, behind a sleep kernel; ``device_name``, ``device_count``).  The
step updates the tables, the row-AdaGrad accumulator and the dense
parameters in place.  ``loss_mean`` is the mean loss of every step after
the two warm-up steps.  ``--routed`` on one process runs ROW_HASH on a
mesh of one, as the port's CLI does; under torchrun every process sits on
the model axis, as the JAX tool puts every device there.

    python -m pim_embedding_lookup_tpu_torch.tools.train_bench --config kaggle \\
        --batch 8192 --iters 20 --hybrid [--wire csr] [--optimizer sgd]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.dlrm import DLRM
from ..models.sparse_train import make_sparse_train_state, make_sparse_train_step
from . import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_bench")
    ap.add_argument("--config", default="kaggle", choices=list(common.CONFIGS))
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--pooling", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--optimizer", default="row_adagrad", choices=["sgd", "row_adagrad"])
    ap.add_argument("--hybrid", action="store_true",
                    help="one-hot matmul small-table + gather big-table embedding collection")
    ap.add_argument("--no-packed", action="store_true",
                    help="disable lane-packed storage (hybrid big set)")
    ap.add_argument("--routed", action="store_true",
                    help="all-to-all id routing for the sharded lookup + scatter update")
    ap.add_argument("--capacity-factor", type=float, default=2.0,
                    help="routed bucket capacity (throughput mode)")
    ap.add_argument("--wire", default="dense", choices=["dense", "csr"],
                    help="query wire shape: dense padded [T,B*L] or the reference's CSR "
                         "indices+offsets -- forward lookup_csr + CSR scatter update")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default 0.1/pooling: SUM pooling scales each "
                         "bag's pooled delta by ~L*lr per step, so lr 0.1 diverges at "
                         "large pooling; timing does not depend on lr)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def build_model(cfg, *, hybrid, packed, policy, device, mesh, seed=0) -> DLRM:
    """The DLRM the bench trains, drawn from ``seed``; ``packed=False``
    stores the hybrid big set [rows, dim]."""
    return DLRM(cfg, policy, hybrid=hybrid, device=device, mesh=mesh,
                packed=None if packed else False,
                generator=torch.Generator(device=device).manual_seed(seed))


def make_inputs(cfg, batch: int, pooling: int, rng: np.random.Generator):
    """(dense [B, dense_dim] f32, ids [T, B*L] int32, labels [B] f32), in
    the JAX tool's draw order."""
    dense = rng.random((batch, cfg.dense_dim), dtype=np.float32)
    idx = common.uniform_ids(rng, cfg.tables, batch * pooling)
    labels = (rng.random(batch) < 0.5).astype(np.float32)
    return dense, idx, labels


class TrainLoop:
    """One call: one sparse train step on the current ids, its loss added
    to ``loss_sum``, then the ids rotated (the JAX tool's loop body)."""

    def __init__(self, model, dense, idx, labels, *, pooling, optimizer, lr, wire,
                 routed=False, capacity_factor=None):
        dev = model.bot[0].weight.device
        b = dense.shape[0]
        self.dense = torch.as_tensor(dense, device=dev)
        self.labels = torch.as_tensor(labels, device=dev)
        self.idx = torch.as_tensor(idx, device=dev)
        self.rows, self.stride = common.rotation(model.config.tables, dev)
        self.dense_opt, self.acc = make_sparse_train_state(model, optimizer=optimizer, lr=lr)
        cf = capacity_factor if routed else None
        if wire == "csr":  # fixed-L bags as CSR offsets: the generic ragged path
            t = self.idx.shape[0]
            self.second = (torch.arange(b + 1, dtype=torch.int32, device=dev) * pooling
                           ).expand(t, -1).contiguous()
        else:
            self.second = torch.ones(self.idx.shape, dtype=torch.bool, device=dev)
        self.step = make_sparse_train_step(model, self.dense_opt, lr=lr, optimizer=optimizer,
                                           routed=routed, capacity_factor=cf, wire=wire)
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.steps = 0

    def __call__(self):
        self.acc, loss = self.step(self.acc, self.dense, self.idx, self.second, self.labels)
        self.loss_sum += loss
        self.steps += 1
        self.idx = common.rotate(self.idx, self.rows, self.stride)
        return loss


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev, mesh, policy, joined = common.tool_mesh(args.device, args.routed)
    try:
        cfg = common.CONFIGS[args.config]()
        model = build_model(cfg, hybrid=args.hybrid, packed=not args.no_packed,
                            policy=policy, device=dev, mesh=mesh)
        print("init done", file=sys.stderr)
        lr = args.lr if args.lr is not None else 0.1 / max(1, args.pooling)
        routed = args.routed and mesh is not None
        dense, idx, labels = make_inputs(cfg, args.batch, args.pooling,
                                         np.random.default_rng(0))
        loop = TrainLoop(model, dense, idx, labels, pooling=args.pooling,
                         optimizer=args.optimizer, lr=lr, wire=args.wire, routed=routed,
                         capacity_factor=args.capacity_factor)
        t0 = time.perf_counter()
        loop()
        loop()
        common.sync(dev)
        print(f"warm in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        loop.loss_sum.zero_()
        loop.steps = 0
        # one step a device run: a step launches hundreds of kernels, and
        # several behind the sleep kernel would fill the launch queue; the
        # sleep is sized from 3 host-timed steps, not one run per timed step
        host_us, device_us = common.loop_us(loop, args.iters, dev, warmup=0,
                                            device_calls=1, device_runs=args.iters,
                                            hold_runs=3)
        result = {
            "metric": f"{args.config}_sparse_train_step",
            "routed": routed,
            "wire": args.wire,
            "lr": lr,
            "us_per_step": round(host_us, 1),
            "samples_per_s": round(args.batch / host_us * 1e6, 1),
            "loss_mean": float(loop.loss_sum) / loop.steps,
            "device_us_per_step": None if device_us is None else round(device_us, 1),
            **common.device_info(dev),
        }
        if common.primary():
            print(json.dumps(result), flush=True)
        return result
    finally:
        common.leave(joined)


if __name__ == "__main__":
    main()
