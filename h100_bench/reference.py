"""The plain reference: a DLRM in plain PyTorch, forward and sparse SGD or
row-wise AdaGrad steps, made from the seed alone.

Embedding bags pool by a gather and a sum over rows that ``gen`` makes
again from (seed, table, row); the MLPs and the dot interaction run in f32
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


def interact(bot: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """[B, D] and [B, T, D] -> [B, D + npairs]: the dense vector, then the
    dots of each pair of the 1+T features below the diagonal, row by row."""
    z = torch.cat([bot[:, None, :], pooled], dim=1)
    nf = z.shape[1]
    li, lj = torch.tril_indices(nf, nf, -1, device=z.device)
    dots = (z[:, li, :] * z[:, lj, :]).sum(-1)
    return torch.cat([bot, dots], dim=1)


def pooled(cfg: dict, seed: int, ids: torch.Tensor, mask: torch.Tensor,
           batch_size: int) -> torch.Tensor:
    """[T, B*L] ids and mask -> [B, T, D] f32 bag sums."""
    t, c = ids.shape
    d = cfg["dim"]
    out = torch.zeros(batch_size, t, d, dtype=torch.float32, device=ids.device)
    pooling = c // batch_size
    step = max(pooling, IDS_A_BLOCK // pooling * pooling)
    for k in range(t):
        for lo in range(0, c, step):
            part = gen.table_rows(seed, cfg, k, ids[k, lo:lo + step].long())
            part = part * mask[k, lo:lo + step, None]
            bags = part.shape[0] // pooling
            out[lo // pooling:lo // pooling + bags, k] = part.view(bags, pooling, d).sum(1)
    return out


class DenseHalf:
    """The bottom and top MLPs from the seed, as tensors of their own."""

    def __init__(self, cfg: dict, seed: int, device):
        self.bot = gen.mlp_weights(seed, [cfg["dense_dim"], *cfg["mlp_bot"]], device, 0)
        self.top = gen.mlp_weights(seed, [top_in(cfg), *cfg["mlp_top"]], device, 1)

    def leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, (w, b) in enumerate(getattr(self, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = w, b
        return out

    def logits(self, dense: torch.Tensor, pooled_: torch.Tensor) -> torch.Tensor:
        z = interact(mlp(self.bot, dense, last_linear=False), pooled_)
        return mlp(self.top, z, last_linear=True)[:, 0]


def top_in(cfg: dict) -> int:
    nf = len(cfg["tables"]) + 1
    return cfg["dim"] + nf * (nf - 1) // 2


def probabilities(cfg: dict, seed: int, dense_half: DenseHalf, b: dict, *,
                  tf32: bool = False) -> torch.Tensor:
    """Click probabilities [B] of one batch."""
    with torch.no_grad(), precision(tf32):
        p = pooled(cfg, seed, b["ids"], b["mask"], b["dense"].shape[0])
        return torch.sigmoid(dense_half.logits(b["dense"], p))


class Trainer:
    """Sparse train steps from the seed over the rows that ``batches``
    touch: each table held as its touched rows alone, the MLPs whole; SGD
    on the MLPs, SGD or row-wise AdaGrad on the rows, as the traffic
    states.  Row AdaGrad adds every entry's mean_d(g^2) to its row's
    accumulator, then steps the row by -lr * rsqrt(acc + eps) * (sum of its
    entries' g)."""

    def __init__(self, cfg: dict, seed: int, batches: list[dict], *, lr: float,
                 optimizer: str, eps: float, device, tf32: bool = False):
        self.cfg, self.seed, self.lr, self.eps, self.tf32 = cfg, seed, lr, eps, tf32
        self.optimizer = optimizer
        self.dense = DenseHalf(cfg, seed, device)
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
        cfg, d = self.cfg, self.cfg["dim"]
        bsz = b["dense"].shape[0]
        t, c = b["ids"].shape
        pooling = c // bsz
        with torch.no_grad():
            pl = torch.zeros(bsz, t, d, device=b["dense"].device)
            for k in range(t):
                r = self.rows[k][self.inv[k][i]]
                pl[:, k] = (r * b["mask"][k, :, None]).view(bsz, pooling, d).sum(1)
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
            for k in range(t):
                inv = self.inv[k][i]
                g_e = g_pooled[:, k, None, :].expand(bsz, pooling, d).reshape(c, d)
                g_e = g_e * b["mask"][k, :, None]
                g_row = torch.zeros_like(self.rows[k]).index_add_(0, inv, g_e)
                out["grads"][f"emb.{k}"] = g_row
                if self.optimizer == "row_adagrad":
                    self.acc[k].index_add_(0, inv, (g_e * g_e).mean(-1))
                    scale = self.lr * torch.rsqrt(self.acc[k] + self.eps)
                    self.rows[k] -= scale[:, None] * g_row
                else:
                    self.rows[k] -= self.lr * g_row
        return out
