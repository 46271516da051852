"""The plain reference: a DLRM in plain PyTorch, forward and sparse SGD or
row-wise AdaGrad steps, made from the seed alone.

Embedding bags pool by a gather and a sum over rows that ``gen`` makes
again from (seed, table, row), on either wire and at any bag length a
table; the dense half is the family's (``dense/<interaction>.py``), in f32
with TF32 off, unless ``tf32`` asks for the control's lower precision.

It imports nothing of the program and takes none of its tensors: its
inputs are the seed, the configuration and the batches the benchmark made.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import gen

IDS_A_BLOCK = 1 << 20  # ids whose rows are made and pooled at a time


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 matmuls with TF32 off, or on for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mlp(layers, x, *, last_linear: bool):
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        x = x @ w.t() + b
        if not (last_linear and i == n - 1):
            x = torch.relu(x)
    return x


def bags(b: dict, k: int, batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each entry's bag in table ``k`` of batch ``b``, and whether it is
    kept: [C] int64 and [C] bool.  The dense wire's entries are bag-major,
    C / B slots a bag, kept by the mask; the CSR wire's entry p is in the
    bag b with offsets[k, b] <= p < offsets[k, b+1], and kept below
    offsets[k, B]."""
    c = b["ids"].shape[1]
    pos = torch.arange(c, device=b["ids"].device)
    if "offsets" not in b:
        return pos // (c // batch_size), b["mask"][k]
    off = b["offsets"][k].long()
    bag = torch.searchsorted(off, pos, right=True) - 1
    return bag.clamp(max=batch_size - 1), pos < off[-1]


def sum_bags(out: torch.Tensor, rows: torch.Tensor, bag: torch.Tensor, b: dict,
             lo: int = 0) -> None:
    """Sums ``rows`` [N, D], the rows of a table's entries lo .. lo+N (the
    kept ones; zeros for the others), into their bags' rows of ``out`` [B,
    D], zeros before the first block.  On the dense wire a block holds
    whole bags, each summed along its slots."""
    if "offsets" in b:
        out.index_add_(0, bag[lo:lo + rows.shape[0]], rows)
        return
    width = b["ids"].shape[1] // out.shape[0]
    n = rows.shape[0] // width
    out[lo // width:lo // width + n] = rows.view(n, width, rows.shape[1]).sum(1)


def pooled(cfg: dict, seed: int, b: dict, batch_size: int) -> torch.Tensor:
    """Batch ``b``'s [B, T, D] f32 bag sums."""
    t, c = b["ids"].shape
    out = torch.zeros(batch_size, t, cfg["dim"], dtype=torch.float32, device=b["ids"].device)
    width = c // batch_size
    step = max(width, IDS_A_BLOCK // width * width)
    for k in range(t):
        bag, keep = bags(b, k, batch_size)
        for lo in range(0, c, step):
            part = gen.table_rows(seed, cfg, k, b["ids"][k, lo:lo + step].long())
            sum_bags(out[:, k], part * keep[lo:lo + step, None], bag, b, lo)
    return out


def probabilities(cfg: dict, seed: int, dense_half, b: dict, *,
                  tf32: bool = False) -> torch.Tensor:
    """Click probabilities [B] of one batch, through ``dense_half`` (the
    family's ``DenseHalf``)."""
    with torch.no_grad(), precision(tf32):
        p = pooled(cfg, seed, b, b["dense"].shape[0])
        return torch.sigmoid(dense_half.logits(b["dense"], p))


class Trainer:
    """Sparse train steps from the seed over the rows that ``batches``
    touch: each table held as its touched rows alone, the dense half
    (``dense_half``, the family's ``DenseHalf``) whole; SGD on its leaves,
    SGD or row-wise AdaGrad on the rows, as the traffic states.  Row
    AdaGrad adds every kept entry's mean_d(g^2) to its row's accumulator,
    then steps the row by -lr * rsqrt(acc + eps) * (sum of its entries' g)."""

    def __init__(self, cfg: dict, seed: int, batches: list[dict], *, dense_half, lr: float,
                 optimizer: str, eps: float, device, tf32: bool = False):
        self.cfg, self.seed, self.lr, self.eps, self.tf32 = cfg, seed, lr, eps, tf32
        self.optimizer = optimizer
        self.dense = dense_half
        for w in self.dense.leaves().values():
            w.requires_grad_(True)
        t = len(cfg["tables"])
        self.uniq, self.inv = [], []
        for k in range(t):
            allids = torch.cat([b["ids"][k].long() for b in batches])
            u, inv = torch.unique(allids, return_inverse=True)
            self.uniq.append(u)
            self.inv.append(list(inv.split([b["ids"].shape[1] for b in batches])))
        self.rows = [gen.table_rows(seed, cfg, k, self.uniq[k]) for k in range(t)]
        self.acc = [torch.zeros(u.numel(), device=device) for u in self.uniq]

    def step(self, i: int, b: dict) -> dict:
        """Step over batch ``i`` of the constructor's list; returns its loss
        and each leaf's gradient (a table's on its touched rows)."""
        d = self.cfg["dim"]
        bsz = b["dense"].shape[0]
        t = b["ids"].shape[0]
        entries = [bags(b, k, bsz) for k in range(t)]
        with torch.no_grad():
            pl = torch.zeros(bsz, t, d, device=b["dense"].device)
            for k, (bag, keep) in enumerate(entries):
                sum_bags(pl[:, k], self.rows[k][self.inv[k][i]] * keep[:, None], bag, b)
        pl.requires_grad_(True)
        leaves = self.dense.leaves()
        with precision(self.tf32):
            loss = F.binary_cross_entropy_with_logits(self.dense.logits(b["dense"], pl),
                                                      b["labels"])
            grads = torch.autograd.grad(loss, [*leaves.values(), pl])
        out = {"loss": float(loss.detach()), "grads": {}}
        with torch.no_grad():
            for (name, w), g in zip(leaves.items(), grads):
                out["grads"][name] = g.clone()
                w -= self.lr * g
            g_pooled = grads[-1]
            for k, (bag, keep) in enumerate(entries):
                inv = self.inv[k][i]
                g_e = g_pooled[:, k][bag] * keep[:, None]
                g_row = torch.zeros_like(self.rows[k]).index_add_(0, inv, g_e)
                out["grads"][f"emb.{k}"] = g_row
                if self.optimizer == "row_adagrad":
                    self.acc[k].index_add_(0, inv, (g_e * g_e).mean(-1))
                    scale = self.lr * torch.rsqrt(self.acc[k] + self.eps)
                    self.rows[k] -= scale[:, None] * g_row
                else:
                    self.rows[k] -= self.lr * g_row
        return out
