"""MLPerf DLRM-DCNv2 on the port: ``DLRMConfig(interaction="dcn")`` and
``models/dlrm.py``'s ``LowRankCrossNet`` over the hybrid collection, held
to the benchmark's plain reference (``h100_bench/dense/dcn.py`` over
``h100_bench/reference.py``, plain PyTorch) on seeded random weights, the
port's weights written from ``gen`` by ``h100_bench/systems/dcn.py``; the
one-card row cut of the configuration tied to the model; the
configuration's checks; and the dot model as it was.

The model is small: 6 tables (3 of at most 8192 rows, in the small set, and
3 above), dim 16, 3 cross layers at rank 8, a bag length a table, B=64."""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu_torch as port
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu_torch.models import sparse_train as tst
from pim_embedding_lookup_tpu_torch.parallel.collection import (
    EmbeddingCollection as TColl,
    _rowshard_pooled_lookup,
    shard_storage,
)
from pim_embedding_lookup_tpu_torch.parallel.planner import plan

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from h100_bench import gen, reference  # noqa: E402
from h100_bench.dense import dcn  # noqa: E402
from h100_bench.systems.dcn import PortSystem  # noqa: E402

CPU = torch.device("cpu")
B = 64
CFG = {"name": "toy-dcn", "source": "https://github.com/mlcommons/training",
       "tables": [50, 20000, 300, 9000, 7, 12000], "dim": 16, "dtype": "float32",
       "dense_dim": 13, "mlp_bot": [32, 16], "mlp_top": [64, 32, 1], "dcn_num_layers": 3,
       "dcn_low_rank_dim": 8, "interaction": "dcn", "collection": "hybrid",
       "small_set_max_rows": 8192, "sharding": "replicate",
       "mesh": {"data": 1, "model": 1}, "reduced": [], "assumed": {}}
LENGTHS = [3, 1, 2, 6, 1, 4]
SEEDS = [5, 2**33 + 7, 3000000019]
# The port against the reference on the CPU, both in f32: the pooled rows
# are the same values (the small set's are bf16 values, so K1's rounding
# to bf16 leaves them as they are), summed in another order, and the cross
# layer's x + x0 * y is one addcmul against a product and a sum.  Logits
# below 1 then differ by an f32 ulp or so through 3 cross layers and 3 top
# layers (6e-8 at most over these seeds): 5e-7 leaves 8x that.  With every
# weight rounded to bf16 (the precision below the configuration's) the
# logits move by ~1e-3.
LOGIT_TOL = dict(rtol=0, atol=5e-7)


def _batch(seed, i, wire="dense", stream=0, cfg=CFG, lengths=LENGTHS, batch_size=B):
    return gen.batch(seed, i, table_rows_=tuple(cfg["tables"]), batch_size=batch_size,
                     pooling=lengths, dense_dim=cfg["dense_dim"], device=CPU, stream=stream,
                     wire=wire)


def _logits(system, b):
    with torch.no_grad():
        if "offsets" in b:
            return system.model.apply_from_pooled(b["dense"], system.lookup(b))
        return system.model(b["dense"], b["ids"], b["mask"])


# -- (a) the forward ------------------------------------------------------------

@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("seed", SEEDS)
def test_forward_matches_reference(seed, wire):
    """The hybrid forward's logits against ``DenseHalf.logits`` over
    ``reference.pooled``, and its probabilities against
    ``reference.probabilities``."""
    s = PortSystem(CFG, seed, CPU)
    dh = dcn.DenseHalf(CFG, seed, CPU)
    for i in range(2):
        b = _batch(seed, i, wire)
        with torch.no_grad():
            want = dh.logits(b["dense"], reference.pooled(CFG, seed, b, B))
        torch.testing.assert_close(_logits(s, b), want, **LOGIT_TOL)
        torch.testing.assert_close(s.predict(b), reference.probabilities(CFG, seed, dh, b),
                                   rtol=0, atol=1e-6)


def test_lower_precision_fails_the_tolerance():
    """The reference with its dense half's weights rounded to bf16 misses
    the logits' tolerance by far, so the tolerance would catch a cross
    network run in bf16."""
    seed = SEEDS[0]
    dh, low = dcn.DenseHalf(CFG, seed, CPU), dcn.DenseHalf(CFG, seed, CPU)
    with torch.no_grad():
        for w in low.leaves().values():
            w.copy_(w.bfloat16().float())
        b = _batch(seed, 0)
        p = reference.pooled(CFG, seed, b, B)
        gap = float((low.logits(b["dense"], p) - dh.logits(b["dense"], p)).abs().max())
    assert gap > 100 * LOGIT_TOL["atol"], gap


def test_cross_layer_is_the_equation():
    """One ``LowRankCrossNet`` layer is x0 * (W (V x) + b) + x, with the
    parameter names and shapes torchrec's layer has."""
    g = torch.Generator().manual_seed(0)
    net = port.models.dlrm.LowRankCrossNet(12, 2, 4, g, CPU)
    names = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert names == {"0.V.weight": (4, 12), "0.W.weight": (12, 4), "0.W.bias": (12,),
                     "1.V.weight": (4, 12), "1.W.weight": (12, 4), "1.W.bias": (12,)}
    assert not net[0]["W"].bias.any()  # torchrec starts b_l at zero
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(generator=g)
        x0 = torch.randn(5, 12, generator=g)
        x = x0
        for layer in net:
            v, w, b = layer["V"].weight, layer["W"].weight, layer["W"].bias
            x = x0 * ((x @ v.t()) @ w.t() + b) + x
        torch.testing.assert_close(net(x0), x, rtol=1e-6, atol=1e-6)


# -- (b) one train step ---------------------------------------------------------

@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_train_step_matches_reference(seed, wire):
    """One row-AdaGrad ``make_sparse_train_step`` against
    ``reference.Trainer``: the loss, every dense leaf's update (each cross
    layer's V, W and b included: ``dense_params`` covers them), and the
    touched rows and their accumulators.  The update is lr times a
    gradient summed over 64 samples in another order: rtol 1e-5 and an
    atol of 1e-7 (~ulp of the largest weights) on the state, 1e-5 of the
    update's own size on the update."""
    traffic = {"optimizer": "row_adagrad", "lr": 0.1, "eps": 1e-8, "wire": wire}
    s = PortSystem(CFG, seed, CPU)
    s.make_train(traffic)
    b = _batch(seed, 0, wire, stream=1)
    ref = reference.Trainer(CFG, seed, [b], dense_half=dcn.DenseHalf(CFG, seed, CPU), lr=0.1,
                            optimizer="row_adagrad", eps=1e-8, device=CPU)
    p0 = {n: p.detach().clone() for n, p in ref.dense.leaves().items()}
    mine = s.dense_leaves()
    assert set(mine) == set(p0) and {n for n in p0 if n.startswith("cross.")} == {
        f"cross.{i}.{part}" for i in range(3) for part in ("V.weight", "W.weight", "W.bias")}
    loss = float(s.train_step(b))
    assert loss == pytest.approx(ref.step(0, b)["loss"], rel=1e-6)
    for name, w0 in p0.items():
        got = mine[name].detach() - w0
        want = ref.dense.leaves()[name].detach() - w0
        assert float(want.abs().max()) > 0, name
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()), msg=name)
    for t in range(len(CFG["tables"])):
        torch.testing.assert_close(s.rows(t, ref.uniq[t]), ref.rows[t], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(s.accumulator(t, ref.uniq[t]), ref.acc[t], rtol=1e-5,
                                   atol=1e-12)


def test_sgd_steps_every_cross_parameter():
    """``dense_params`` is every parameter of the dense tower, so that the
    dense optimizer (and on a mesh the data-axis sum) covers the cross
    layers: one SGD step moves each of them."""
    s = PortSystem(CFG, 5, CPU)
    assert tst.dense_params(s.model) == list(s.model.parameters())
    before = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    s.make_train({"optimizer": "sgd", "lr": 0.1, "eps": 1e-8, "wire": "dense"})
    s.train_step(_batch(5, 0, stream=1))
    for n, p in s.model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


# -- (c) the one-card cut -------------------------------------------------------

SPLIT = 40000  # a 40,000,000-row table, scaled down; four cards split it by rows
SPLIT_LENGTHS = [3, 7, 12, 100, 27]  # the published lengths of the five split tables
M = 4


def _split_cfg(dim=16):
    return {"tables": [SPLIT] * len(SPLIT_LENGTHS), "dim": dim, "small_set_max_rows": 8192}


@pytest.mark.parametrize("quarter", [False, True], ids=["whole-table-ids", "first-quarter-ids"])
def test_row_shards_add_up_to_the_table(quarter):
    """Each of the five split tables cut by ``ROW`` into 4 row shards: the
    shards' partial pools of a DCNv2-shaped batch (the published bag
    lengths, padded to 100 slots and masked) add up to the reference's pool
    of the whole table.  With ids drawn from the first quarter, as the
    one-card cell draws them, shard 0's partial is the whole pool and the
    other shards add nothing: the card's pool is what its shard
    contributes."""
    seed, cfg = 2**33 + 1, _split_cfg()
    rows = SPLIT // M if quarter else SPLIT
    b = gen.batch(seed, 0, table_rows_=(rows,) * len(SPLIT_LENGTHS), batch_size=32,
                  pooling=SPLIT_LENGTHS, dense_dim=13, device=CPU)
    want = reference.pooled(cfg, seed, b, 32)
    width = max(SPLIT_LENGTHS)
    for k in range(len(SPLIT_LENGTHS)):
        table = tcfg.TableConfig(num_rows=SPLIT, dim=cfg["dim"], name=f"split_{k}")
        coll = TColl(plan((table,), M, tcfg.ShardingPolicy.ROW, False), CPU)
        lay = coll.layout
        assert lay.rows_per_shard == SPLIT // M
        host = gen.table_rows(seed, cfg, k, torch.arange(SPLIT)).numpy()
        fused = coll.fused_host_array([host])
        g = coll.globalize(b["ids"][k:k + 1])
        parts = [_rowshard_pooled_lookup(
            torch.from_numpy(np.ascontiguousarray(shard_storage(lay, s, fused))), cfg["dim"],
            g, b["mask"][k:k + 1], width, "sum", shard=s, num_shards=M,
            rows_per_shard=lay.rows_per_shard, strided=False)[:, 0] for s in range(M)]
        torch.testing.assert_close(sum(parts), want[:, k], rtol=1e-6, atol=1e-6)
        if quarter:
            torch.testing.assert_close(parts[0], want[:, k], rtol=1e-6, atol=1e-6)
            assert all(not p.any() for p in parts[1:])


def test_preset_is_the_benchmark_configuration():
    """``mlperf_dcnv2_config``: the published tables whole, one card's share
    at ``row_shards=4`` as the benchmark's configuration holds it, and the
    bag lengths of its traffic."""
    bench = json.loads((REPO / "h100_bench/configs/mlperf-dcnv2.json").read_text())
    traffic = json.loads((REPO / "h100_bench/traffic/offline-b65536-dcnv2.json").read_text())
    whole, card = tcfg.mlperf_dcnv2_config(), tcfg.mlperf_dcnv2_config(row_shards=4)
    assert [t.num_rows for t in whole.tables] == bench["assumed"]["published_tables"]
    assert sum(t.num_rows for t in whole.tables) == 204_184_588
    assert [t.num_rows for t in card.tables] == bench["tables"]
    assert sum(t.num_rows for t in card.tables) == 54_184_588
    assert list(tcfg.DCNV2_BAG_LENGTHS) == traffic["pooling"]
    assert sum(tcfg.DCNV2_BAG_LENGTHS) == 214
    for key in ("dense_dim", "dcn_num_layers", "dcn_low_rank_dim"):
        assert getattr(card, key) == bench[key]
    assert (list(card.mlp_bot), list(card.mlp_top)) == (bench["mlp_bot"], bench["mlp_top"])
    assert {t.dim for t in card.tables} == {bench["dim"]} and card.interaction == "dcn"
    with pytest.raises(ValueError, match="row_shards"):
        tcfg.mlperf_dcnv2_config(row_shards=3)


# -- (d) the configuration's checks, and the dot model as it was --------------------

def _dlrm_config(cfg, **kw):
    tables = tuple(tcfg.TableConfig(num_rows=n, dim=cfg["dim"], name=f"t{i}")
                   for i, n in enumerate(cfg["tables"]))
    extra = ({"dcn_num_layers": cfg["dcn_num_layers"],
              "dcn_low_rank_dim": cfg["dcn_low_rank_dim"]}
             if cfg["interaction"] == "dcn" else {})
    return tcfg.DLRMConfig(dense_dim=cfg["dense_dim"], mlp_bot=tuple(cfg["mlp_bot"]),
                           mlp_top=tuple(cfg["mlp_top"]), tables=tables,
                           interaction=cfg["interaction"], **{**extra, **kw})


@pytest.mark.parametrize("kw", [dict(interaction="cat"), dict(interaction=""),
                                dict(interaction="dcn", dcn_num_layers=3),
                                dict(interaction="dcn", dcn_low_rank_dim=8),
                                dict(interaction="dcn", dcn_num_layers=0, dcn_low_rank_dim=8)],
                         ids=["cat", "empty", "dcn-no-rank", "dcn-no-layers", "dcn-0-layers"])
def test_config_refuses(kw):
    with pytest.raises(ValueError, match="interaction"):
        tcfg.DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(1,),
                        tables=(tcfg.TableConfig(num_rows=10, dim=16),), **kw)


def test_unequal_dims_refused_for_either_interaction():
    for interaction in ("dot", "dcn"):
        cfg = tcfg.DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(1,),
                              tables=(tcfg.TableConfig(num_rows=10, dim=16),
                                      tcfg.TableConfig(num_rows=10, dim=8)),
                              interaction=interaction, dcn_num_layers=1, dcn_low_rank_dim=4)
        with pytest.raises(ValueError, match="one dim"):
            cfg.sparse_dim


def test_top_mlp_sized_by_the_interaction():
    """The top MLP takes the interaction's width: (1 + T) * d for dcn,
    d + npairs for dot."""
    for interaction, want in (("dcn", 7 * 16), ("dot", 16 + 7 * 6 // 2)):
        model = port.DLRM(_dlrm_config(dict(CFG, interaction=interaction)),
                          tcfg.ShardingPolicy.REPLICATE, hybrid=True, device=CPU,
                          generator=torch.Generator().manual_seed(0))
        assert model.top[0].in_features == want
        assert hasattr(model, "cross") == (interaction == "dcn")


# The dot model below, at the commit before the cross interaction came in:
# its parameter names, the sha256 of its state dict (names and bytes) and of
# its logits for the query _dot_query makes.
DOT_ROWS = (50, 20000, 300, 9000, 7, 12000)
DOT_NAMES = ["bot.0.weight", "bot.0.bias", "bot.1.weight", "bot.1.bias", "top.0.weight",
             "top.0.bias", "top.1.weight", "top.1.bias", "top.2.weight", "top.2.bias"]
DOT_STATE = "07f8496679ed46625ca46cee9fe0bdbe91ffa7dfe6c42fdc7b6beaeb53e2871e"
DOT_LOGITS = "c0da60e59f331ab105d27dff02d75fa442d07433fa1b4b1f5be1bc794e57275f"


def _dot_query():
    g = torch.Generator().manual_seed(11)
    ids = torch.stack([torch.randint(0, n, (64 * 3,), generator=g) for n in DOT_ROWS])
    mask = torch.rand(len(DOT_ROWS), 64 * 3, generator=g) < 0.7
    return torch.rand(64, 13, generator=g), ids.to(torch.int32), mask


def test_dot_model_bit_for_bit():
    tables = tuple(tcfg.TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate(DOT_ROWS))
    cfg = tcfg.DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(64, 32, 1), tables=tables)
    model = port.DLRM(cfg, tcfg.ShardingPolicy.REPLICATE, hybrid=True, device=CPU,
                      generator=torch.Generator().manual_seed(7))
    assert [n for n, _ in model.named_parameters()] == DOT_NAMES
    h = hashlib.sha256()
    for n, t in model.state_dict().items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == DOT_STATE
    with torch.no_grad():
        out = model(*_dot_query())
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == DOT_LOGITS
