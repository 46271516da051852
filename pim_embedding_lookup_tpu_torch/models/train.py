"""Training loop: BCE + SGD, accuracy/AUC metrics, train and eval steps.

The counterpart of ``pim_embedding_lookup_tpu.models.train``.  This step
differentiates through the lookup, so the embedding storage gets a dense
[rows, D] gradient (the transpose of the gather, see
``ops.gather_pool.embedding_bag_fixedl_grad``); ``sparse_train`` avoids
that.  The model's tensors are trained in place, which stands in for the
JAX step's returned params: an optimizer here is a factory that binds an
optimizer rule to tensors, as an optax transformation is bound to a
params tree by ``init``.

On a mesh each process feeds its data row's slice of the batch.  The loss
is the mean over the global batch (each process divides by the global B);
the lookups' backward sums the tables' gradients over the data axis
(``parallel.collection``), and the step sums the dense params' gradients
over it, once each.  Evaluation gathers the probabilities over the data
axis, so the metrics cover the global batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..parallel.mesh import DATA_AXIS
from .dlrm import DLRM, bce_loss

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


class OptaxAdagrad(torch.optim.Optimizer):
    """optax's AdaGrad rule: the sum of squares starts at
    ``initial_accumulator_value``, then per step ``acc += g * g`` and
    ``p -= lr * g * rsqrt(acc + eps)`` (0 where acc is 0).
    ``torch.optim.Adagrad`` starts at 0 and adds eps outside the square
    root, a different rule."""

    def __init__(self, params, lr: float = 0.1, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum_of_squares"]
                acc.add_(g * g)
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.add_((inv * g) * -group["lr"])
        return loss


def make_optimizer(lr: float = 0.1, kind: str = "sgd") -> OptimizerFactory:
    """SGD at lr 0.1 by default (``torch.optim.SGD`` without momentum is
    ``optax.sgd``'s rule); "adagrad" is optax's rule (``OptaxAdagrad``).
    Returns a factory: call it with the tensors to train."""
    if kind == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr)
    if kind == "adagrad":
        return functools.partial(OptaxAdagrad, lr=lr)
    raise ValueError(kind)


def emb_tensors(model: DLRM) -> list[torch.Tensor]:
    """The model's embedding storage tensors (its buffers)."""
    emb = model.emb_params()
    if isinstance(emb, dict):
        return [t for t in emb.values() if t is not None]
    return [emb]


def sum_grads_over_data(mesh, params):
    """Sum the params' gradients over the data axis, as one flat
    all-reduce."""
    flat = mesh.psum(torch.cat([p.grad.reshape(-1) for p in params]), DATA_AXIS)
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.grad.numel()].view_as(p.grad))
        at += p.grad.numel()


def make_train_step(model: DLRM, optimizer: OptimizerFactory) -> Callable:
    """A step over (dense, indices, mask, labels) that differentiates the
    BCE loss w.r.t. every tensor of ``model``, the embedding storage
    included, and applies ``optimizer`` to all of them in place.  The
    storage is marked as requiring grad, so the lookups build their
    backward; a lookup under ``torch.no_grad`` still builds none.  On a
    mesh the batch is this process's data row's slice (module docstring).
    Returns (loss, logits), detached: the global loss, this slice's
    logits."""
    tables = emb_tensors(model)
    for t in tables:
        t.requires_grad_(True)
    params = list(model.parameters())  # the MLPs: the tables are buffers
    opt = optimizer([*params, *tables])
    mesh = model.collection.mesh

    def train_step(dense, indices, mask, labels):
        opt.zero_grad(set_to_none=True)
        logits = model(dense, indices, mask)
        loss = bce_loss(logits, labels)
        if mesh is not None:  # the mean over the global batch
            loss = loss / mesh.data
        loss.backward()
        if mesh is not None:
            sum_grads_over_data(mesh, params)
            loss = mesh.psum(loss.detach().clone(), DATA_AXIS)
        opt.step()
        return loss.detach(), logits.detach()

    return train_step


def make_eval_step(model: DLRM) -> Callable:
    """Click probabilities of (dense, indices, mask); on a mesh those of
    this data row's slice."""
    @torch.no_grad()
    def eval_step(dense, indices, mask):
        return torch.sigmoid(model(dense, indices, mask))

    return eval_step


def binary_accuracy(probs: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean((probs > 0.5) == (labels > 0.5)))


def roc_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney) with average ranks for ties; NaN when
    only one class is present."""
    order = np.argsort(probs, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_p = probs[order]
    i = 0
    n = len(probs)
    while i < n:
        j = i
        while j + 1 < n and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos = labels > 0.5
    npos = int(pos.sum())
    nneg = n - npos
    if npos == 0 or nneg == 0:
        return float("nan")
    return float((ranks[pos].sum() - npos * (npos + 1) / 2) / (npos * nneg))


@dataclasses.dataclass
class TrainReport:
    step: int
    loss: float
    accuracy: float
    auc: float


def fit(
    model: DLRM,
    batches: Iterator,
    *,
    lr: float = 0.1,
    optimizer_kind: str = "sgd",
    test_freq: int = 0,
    test_batches: list | None = None,
    log_fn: Callable[[TrainReport], None] | None = None,
) -> list[TrainReport]:
    """Train ``model`` in place over (dense, indices, mask, labels)
    batches (tensors or numpy arrays; moved to the model's device), and
    every ``test_freq`` steps report loss, accuracy and AUC on
    ``test_batches``.  On a mesh every batch is this process's data row's
    slice, and the reports cover the global batches.  Returns the
    reports."""
    device = model.collection.device
    mesh = model.collection.mesh
    as_dev = functools.partial(torch.as_tensor, device=device)

    def global_batch(x):
        x = as_dev(x)
        return x if mesh is None else mesh.all_gather(x.contiguous(), DATA_AXIS, 0)

    train_step = make_train_step(model, make_optimizer(lr, optimizer_kind))
    eval_step = make_eval_step(model)
    reports: list[TrainReport] = []
    step = 0
    for dense, indices, mask, labels in batches:
        loss, _ = train_step(as_dev(dense), as_dev(indices), as_dev(mask), as_dev(labels))
        step += 1
        if test_freq and step % test_freq == 0 and test_batches:
            probs, labs = [], []
            for tdense, tindices, tmask, tlabels in test_batches:
                probs.append(global_batch(eval_step(as_dev(tdense), as_dev(tindices),
                                                    as_dev(tmask))).cpu().numpy())
                labs.append(global_batch(tlabels).cpu().numpy())
            probs, labs = np.concatenate(probs), np.concatenate(labs)
            rep = TrainReport(step=step, loss=float(loss),
                              accuracy=binary_accuracy(probs, labs),
                              auc=roc_auc(probs, labs))
            reports.append(rep)
            if log_fn:
                log_fn(rep)
    return reports
