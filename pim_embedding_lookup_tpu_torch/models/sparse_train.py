"""Memory-efficient training: the dense tower by a torch optimizer, the
embedding half by the sparse scatter step (``parallel/sparse_update.py``).

The counterpart of ``pim_embedding_lookup_tpu.models.sparse_train``.  The
step built here

  1. runs the lookup forward (no autograd graph through the tables),
  2. differentiates only the dense tower w.r.t. its params and the pooled
     embeddings,
  3. adds d(loss)/d(pooled) straight into the fused storage as an SGD or
     row-wise AdaGrad step,

so no dense [rows, D] gradient is built and the update costs O(entries).
On a mesh each process feeds its data row's slice of the batch: the loss is
the mean over the global batch (each process divides by the global B), the
dense gradients are summed over the data axis, and the step returns the
global loss; model peers see the same pooled tensor, so their dense steps
agree with no further collective.  The embedding storage, the accumulator and the MLP params are updated in
place, which stands in for the JAX step's buffer donation.  The step
takes either wire (``wire=``): the dense one's ``(indices, mask)`` or the
CSR one's ``(indices, offsets)``, whose step is ``lookup_csr``, the dense
tower, then the CSR scatter update (the JAX package composes that step by
hand in its ``tools/train_bench.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.hybrid import (
    HybridEmbeddingCollection,
    init_accumulator_hybrid,
    sparse_update_hybrid,
    sparse_update_hybrid_csr,
)
from ..parallel.mesh import DATA_AXIS
from ..parallel.sparse_update import init_accumulator, sparse_update, sparse_update_csr
from ..utils.profiling import span
from .dlrm import DLRM, bce_loss
from .train import OptimizerFactory, make_optimizer, sum_grads_over_data


def _init_acc(coll):
    if isinstance(coll, HybridEmbeddingCollection):
        return init_accumulator_hybrid(coll)
    return init_accumulator(coll)


def _apply_sparse(coll, emb, acc, indices, mask, g_pooled, *, lr, optimizer,
                  eps, routed=False, capacity_factor=None):
    update = sparse_update_hybrid if isinstance(coll, HybridEmbeddingCollection) else sparse_update
    return update(coll, emb, acc, indices, mask, g_pooled, lr=lr, optimizer=optimizer,
                  eps=eps, routed=routed, capacity_factor=capacity_factor)


def _apply_sparse_csr(coll, emb, acc, indices, offsets, g_pooled, *, lr,
                      optimizer, eps, routed=False, data_sharded=False,
                      capacity_factor=None):
    """CSR-wire twin of _apply_sparse: the backward of lookup_csr."""
    update = (sparse_update_hybrid_csr if isinstance(coll, HybridEmbeddingCollection)
              else sparse_update_csr)
    return update(coll, emb, acc, indices, offsets, g_pooled, lr=lr, optimizer=optimizer,
                  eps=eps, routed=routed, data_sharded=data_sharded,
                  capacity_factor=capacity_factor)


def dense_params(model: DLRM) -> list[torch.Tensor]:
    """The dense tower's params: the bot and top MLPs and, in a DCNv2
    model, the cross layers (the tables are buffers)."""
    return list(model.parameters())


def make_sparse_train_state(
    model: DLRM, *, optimizer: str = "sgd", lr: float = 0.1,
    dense_optimizer: OptimizerFactory | None = None,
) -> tuple[torch.optim.Optimizer, torch.Tensor | dict]:
    """Returns (dense_opt, acc): ``dense_optimizer`` (SGD at ``lr`` by
    default, optax.sgd's rule) bound to the bot/top params, and the
    row-AdaGrad accumulator, allocated for either embedding optimizer so
    that the step's signature does not depend on it."""
    del optimizer  # the accumulator is allocated for both
    dense_opt = (dense_optimizer or make_optimizer(lr))(dense_params(model))
    return dense_opt, _init_acc(model.collection)


def make_sparse_train_step(
    model: DLRM,
    dense_opt: torch.optim.Optimizer,
    *,
    lr: float = 0.1,
    optimizer: str = "sgd",  # embedding optimizer: "sgd" | "row_adagrad"
    eps: float = 1e-8,
    routed: bool = False,
    capacity_factor: float | None = None,
    hot_cache: bool = False,
    wire: str = "dense",  # "dense" | "csr"
) -> Callable:
    """The step ``(acc, dense, indices, mask, labels[, hot_ids, hot_rows])
    -> (acc, loss)`` over the dense wire, or ``(acc, dense, indices,
    offsets, labels) -> (acc, loss)`` over the CSR wire (``wire="csr"``:
    [T, C] ids and [T, B+1] offsets of this process's slice of the batch).
    It updates the model's embedding storage, ``acc`` and the MLP params in
    place; the loss is detached.

    ``routed=True`` (a model on a mesh) sends the big-set lookup and the
    scatter update through the all-to-all routing; drop-safe at the default
    ``capacity_factor``.  ``hot_cache=True`` (routed only): the step takes
    two trailing args, a hot-row snapshot from ``hotcache.build_hot_cache``
    that serves hot entries locally; it goes stale as updates land and the
    caller rebuilds it."""
    if wire not in ("dense", "csr"):
        raise ValueError(f"wire must be 'dense' or 'csr', got {wire!r}")
    if hot_cache and not routed:
        raise ValueError("hot_cache is a routed-lookup feature")
    if hot_cache and wire == "csr":
        raise ValueError("hot_cache serves the dense wire's routed lookup only")
    coll = model.collection
    mesh = coll.mesh
    if routed and mesh is None:
        raise ValueError("a routed sparse train step needs a model on a mesh "
                         "(DLRM(..., mesh=...))")
    hybrid = isinstance(coll, HybridEmbeddingCollection)
    params = dense_params(model)

    def lookup(indices, mask, b, hc):
        emb = model.emb_params()
        if wire == "csr":  # mask: the offsets
            kw = dict(routed=True, capacity_factor=capacity_factor) if routed else {}
            return coll.lookup_csr(emb, indices, mask, **kw)
        if not routed:
            return coll.lookup(emb, indices, mask, batch_size=b)
        kw = dict(batch_size=b, capacity_factor=capacity_factor, hot_cache=hc)
        if hybrid:
            return coll.lookup(emb, indices, mask, routed=True, **kw)
        return coll.lookup_routed(emb, indices, mask, **kw)

    def train_step(acc, dense, indices, mask, labels, *hc_args):
        if bool(hc_args) != hot_cache:
            raise TypeError("step built with hot_cache=%s but got %d trailing cache args"
                            % (hot_cache, len(hc_args)))
        with span("pel.train_step"):
            with torch.no_grad():
                pooled = lookup(indices, mask, dense.shape[0], hc_args or None)  # [B, T, D]
            pooled.requires_grad_(True)
            with span("pel.train.dense"):
                dense_opt.zero_grad(set_to_none=True)
                loss = bce_loss(model.apply_from_pooled(dense, pooled), labels)
                if mesh is not None:  # the mean over the global batch
                    loss = loss / mesh.data
                loss.backward()
                if mesh is not None:
                    sum_grads_over_data(mesh, params)
                    loss = mesh.psum(loss.detach().clone(), DATA_AXIS)
                dense_opt.step()
            apply = _apply_sparse_csr if wire == "csr" else _apply_sparse
            with torch.no_grad():
                _, acc = apply(coll, model.emb_params(), acc, indices, mask, pooled.grad,
                               lr=lr, optimizer=optimizer, eps=eps, routed=routed,
                               capacity_factor=capacity_factor)
        return acc, loss.detach()

    return train_step
