"""DLRM: bottom MLP over dense features, pooled embedding lookups, an
interaction, top MLP to one logit.  The interaction is the pairwise dot one
or a low-rank cross network (DLRM-DCNv2).

The counterpart of ``pim_embedding_lookup_tpu.models.dlrm`` as an
``nn.Module`` (whose interaction is the dot one).  The embedding storage is
held as buffers in the fused layout of its collection; the MLPs and the
cross layers are ``nn.Linear`` layers in f32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..config import DLRMConfig, ShardingPolicy
from ..device import resolve_device
from ..parallel.collection import EmbeddingCollection
from ..parallel.hybrid import HybridEmbeddingCollection
from ..utils.profiling import span


def _init_mlp(sizes: Sequence[int], generator: torch.Generator,
              device: torch.device) -> nn.ModuleList:
    """dlrm-style init: normal(0, sqrt(2/(fan_in+fan_out))) for W and b."""
    layers = nn.ModuleList()
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        # built on meta, so nn.Linear's own init draws nothing
        lin = nn.Linear(fan_in, fan_out, device="meta").to_empty(device=device)
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        with torch.no_grad():
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.normal_(0.0, std, generator=generator)
        layers.append(lin)
    return layers


def _apply_mlp(layers: nn.ModuleList, x: torch.Tensor, *,
               sigmoid_last: bool) -> torch.Tensor:
    """Linear layers with ReLU between them; the last layer gives logits
    when ``sigmoid_last`` (the sigmoid is left to the caller or the loss)."""
    n = len(layers)
    for i, lin in enumerate(layers):
        x = lin(x)
        if not (i == n - 1 and sigmoid_last):
            x = torch.relu(x)
    return x


class _TrilPairs(torch.autograd.Function):
    """``zz[:, li, lj]`` whose backward writes the cotangent into zeros.

    The (li, lj) pairs are distinct, so no entry of the gradient takes two
    values and a plain write gives the sum that the indexing's own backward,
    an accumulating ``index_put_`` (on CUDA a sort of every entry), gives."""

    @staticmethod
    def forward(ctx, zz, li, lj):
        ctx.save_for_backward(li, lj)
        ctx.zz_shape = zz.shape
        return zz[:, li, lj]

    @staticmethod
    def backward(ctx, g):
        li, lj = ctx.saved_tensors
        with span("pel.interact.backward"):
            gz = g.new_zeros(ctx.zz_shape)
            gz[:, li, lj] = g
        return gz, None, None


def interact_dot(bot_out: torch.Tensor, pooled: torch.Tensor, *,
                 self_interaction: bool) -> torch.Tensor:
    """Pairwise dot-product interaction.

    bot_out [B, D], pooled [B, T, D] -> [B, D + npairs]: the dense vector,
    then the dots of the (1+T) features in ``np.tril_indices`` order, row by
    row (below the diagonal, or including it with ``self_interaction``)."""
    z = torch.cat([bot_out[:, None, :], pooled], dim=1)  # [B, 1+T, D]
    zz = torch.bmm(z, z.transpose(1, 2))  # [B, 1+T, 1+T]
    nf = z.shape[1]
    li, lj = torch.tril_indices(nf, nf, 0 if self_interaction else -1,
                                device=zz.device)
    return torch.cat([bot_out, _TrilPairs.apply(zz, li, lj)], dim=1)


class LowRankCrossNet(nn.ModuleList):
    """torchrec's ``LowRankCrossNet``: layer l maps x_l to

        x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

    with V_l a bias-free [rank, width] ``nn.Linear`` and W_l a [width, rank]
    one with its bias b_l; layer l is ``self[l]``, its parts ``"V"`` and
    ``"W"``.  V_l and W_l are drawn normal(0, sqrt(2 / (width + rank)))
    (torchrec's ``xavier_normal_``), b_l is zero."""

    def __init__(self, width: int, num_layers: int, rank: int, generator: torch.Generator,
                 device: torch.device):
        std = float(np.sqrt(2.0 / (width + rank)))
        layers = []
        for _ in range(num_layers):
            layer = nn.ModuleDict({
                "V": nn.Linear(width, rank, bias=False, device="meta"),
                "W": nn.Linear(rank, width, device="meta"),
            }).to_empty(device=device)
            with torch.no_grad():
                layer["V"].weight.normal_(0.0, std, generator=generator)
                layer["W"].weight.normal_(0.0, std, generator=generator)
                layer["W"].bias.zero_()
            layers.append(layer)
        super().__init__(layers)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in self:
            # x + x0 * y in one pass
            x = torch.addcmul(x, x0, layer["W"](layer["V"](x)))
        return x


def interact_dcn(bot_out: torch.Tensor, pooled: torch.Tensor,
                 cross: LowRankCrossNet) -> torch.Tensor:
    """The DCNv2 interaction: bot_out [B, D] and pooled [B, T, D] flattened
    into x0 [B, (1+T) D], the dense vector first, then the cross network."""
    x0 = torch.cat([bot_out[:, None, :], pooled], dim=1).flatten(1)
    with span("pel.cross"):
        return cross(x0)


class DLRM(nn.Module):
    """DLRM over an embedding collection (hybrid or plain).

    Query format: dense [B, dense_dim] f32, indices [T, B*L] per-table local
    row ids (bag-major), mask [T, B*L] bool.  ``forward`` returns [B]
    logits.  Built on ``device`` (CUDA unless named) with weights drawn from
    ``generator``, which must live on that device.  On a ``mesh``
    (``parallel.mesh.PortMesh``) the device is the mesh's, the embedding
    buffers are this process's shards, and a query is this process's data
    row's slice of the batch; one seed gives the same model on every mesh.
    ``packed``: the collection's lane packing (its ``create``'s ``packed``;
    None keeps that default).
    """

    def __init__(
        self,
        config: DLRMConfig,
        policy: ShardingPolicy = ShardingPolicy.AUTO,
        *,
        hybrid: bool = False,
        device=None,
        generator: torch.Generator,
        mesh=None,
        packed: bool | str | None = None,
    ):
        super().__init__()
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "DLRM runs its MLPs in full f32; "
                "torch.backends.cuda.matmul.allow_tf32 must be False"
            )
        device = mesh.device if mesh is not None else resolve_device(device)
        self.config = config
        self.hybrid = hybrid
        coll = HybridEmbeddingCollection if hybrid else EmbeddingCollection
        kw = {} if packed is None else dict(packed=packed)
        self.collection = coll.create(config.tables, policy, device=device, mesh=mesh, **kw)
        d = config.sparse_dim
        if config.mlp_bot[-1] != d:
            raise ValueError(
                f"bot MLP must end at sparse dim {d}, got {config.mlp_bot[-1]}"
            )
        nf = config.num_tables + 1
        if config.interaction == "dcn":
            top_in = nf * d
        else:
            npairs = nf * (nf + 1) // 2 if config.interact_itself else nf * (nf - 1) // 2
            top_in = d + npairs
        emb = self.collection.init(generator)
        if hybrid:
            self.register_buffer("emb_small", emb["small"])
            self.register_buffer("emb_big", emb["big"])
        else:
            self.register_buffer("emb", emb)
        self.bot = _init_mlp([config.dense_dim, *config.mlp_bot], generator, device)
        self.top = _init_mlp([top_in, *config.mlp_top], generator, device)
        if config.interaction == "dcn":
            self.cross = LowRankCrossNet(top_in, config.dcn_num_layers,
                                         config.dcn_low_rank_dim, generator, device)

    def emb_params(self):
        """The embedding storage in the form its collection's lookup takes."""
        if self.hybrid:
            return {"small": self.emb_small, "big": self.emb_big}
        return self.emb

    def apply_from_pooled(self, dense: torch.Tensor,
                          pooled: torch.Tensor) -> torch.Tensor:
        """Dense half only: bot MLP -> interaction -> top MLP -> [B] logits."""
        bot_out = _apply_mlp(self.bot, dense, sigmoid_last=False)
        if self.config.interaction == "dcn":
            zi = interact_dcn(bot_out, pooled, self.cross)
        else:
            zi = interact_dot(bot_out, pooled,
                              self_interaction=self.config.interact_itself)
        return _apply_mlp(self.top, zi, sigmoid_last=True)[:, 0]

    def forward(self, dense: torch.Tensor, indices: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        with span("pel.forward"):
            pooled = self.collection.lookup(
                self.emb_params(), indices, mask, batch_size=dense.shape[0]
            )  # [B, T, D]
            return self.apply_from_pooled(dense, pooled)

    def predict(self, dense, indices, mask) -> torch.Tensor:
        """Click probabilities."""
        return torch.sigmoid(self(dense, indices, mask))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, in the JAX package's closed form."""
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
