"""The port's int8 capacity mode on a (data=2, model=2) gloo cluster against
the JAX package on a mesh of the same shape: the int8 case group of
``mesh_battery`` (``Int8Battery``), in its own cluster of 4 CPU processes.
``QuantizedEmbeddingCollection``'s broadcast, data-sharded and routed
lookups (tests/test_quantized_collection.py:248-292), the routed lookup with
a hot-row cache built against the int8 params (:403-444), and the ROW_HASH
hybrid DLRM quantized by ``quantize_dlrm_embeddings`` and served, in both
scale modes.  Cluster, comparison and tolerances are those of
``test_torch_port_mesh.py``."""

import numpy as np
import pytest

import pim_embedding_lookup_tpu.config as jcfg
from pim_embedding_lookup_tpu.models import quantize_dlrm_embeddings as jquantize
from pim_embedding_lookup_tpu.parallel import hotcache as jhot
from pim_embedding_lookup_tpu.parallel.quantized_collection import (
    QuantizedEmbeddingCollection as JQColl,
)
from pim_embedding_lookup_tpu_torch import mesh_battery as mb
from test_torch_port_mesh import _j, _model, check_case, start_cluster

MESH = (2, 2)  # (data, model)


def _qcoll(jm, inp, policy, mode):
    jc = JQColl.create(mb.tables(jcfg, mb.ROWS), jm, jcfg.ShardingPolicy(policy),
                       scale_mode=mode)
    return jc, jc.quantize_tables(mb.host_tables(inp, "table", mb.ROWS))


def _q_lookup(jm, inp, policy, mode, combiner):
    jc, p = _qcoll(jm, inp, policy, mode)
    return {"out": jc.lookup(p, _j(inp["idx"]), _j(inp["mask"]), batch_size=mb.BATCH,
                             combiner=combiner)}


def _q_csr_ds(jm, inp, policy, mode):
    jc, p = _qcoll(jm, inp, policy, mode)
    return {"out": jc.lookup_csr(p, _j(inp["widx"]), _j(inp["woff"]), combiner="mean",
                                 data_sharded=True)}


def _q_routed(jm, inp, policy, mode, hot=False):
    jc, p = _qcoll(jm, inp, policy, mode)
    res, cache, cf = {}, None, None
    if hot:
        cache = jhot.build_hot_cache(jc, p, jhot.hot_ids_from_sample(jc, inp["zidx"],
                                                                     mb.HOT_K))
        res["hot_rows"], cf = cache[1], 1.0
    out, dropped = jc.lookup_routed(p, _j(inp["zidx"]), _j(inp["zmask"]),
                                    batch_size=mb.BATCH, capacity_factor=cf,
                                    hot_cache=cache, return_stats=True)
    return {**res, "out": out, "dropped": dropped}


def _q_csr_routed(jm, inp, policy, mode, ds=False):
    jc, p = _qcoll(jm, inp, policy, mode)
    q = (inp["widx"], inp["woff"]) if ds else (inp["cidx"], inp["coff"])
    out, dropped = jc.lookup_csr(p, *map(_j, q), data_sharded=ds, routed=True,
                                 capacity_factor=1.0 if ds else None, return_stats=True)
    return {"out": out, "dropped": dropped}


def _q_serve(jm, inp, mode):
    model, params = _model(jm, inp, "row_hash")
    coll, sp = jquantize(model, params, scale_mode=mode)
    dense, idx, mask = (_j(inp[f"{k}0"]) for k in ("mdense", "midx", "mmask"))
    sample = inp["midx0"][list(coll.big_ids)]
    cache = jhot.build_hot_cache(coll.big, sp["emb"]["big"],
                                 jhot.hot_ids_from_sample(coll.big, sample, mb.HOT_K))
    pooled = coll.lookup(sp["emb"], idx, mask, batch_size=mb.BATCH)
    routed = coll.lookup(sp["emb"], idx, mask, batch_size=mb.BATCH, routed=True,
                         hot_cache=cache)
    return {"broadcast": model.apply_from_pooled(sp, dense, pooled),
            "routed_hot": model.apply_from_pooled(sp, dense, routed),
            "hot_rows": cache[1], **{f"big_{k}": v for k, v in sp["emb"]["big"].items()}}


def _expected(name, jm, inp):
    kind, *rest = name.split("-")
    if kind == "q_lookup":
        return _q_lookup(jm, inp, *rest)
    if kind == "q_csr_ds":
        return _q_csr_ds(jm, inp, *rest)
    if kind == "q_routed":
        return _q_routed(jm, inp, *rest)
    if kind == "q_hot":
        return _q_routed(jm, inp, *rest, hot=True)
    if kind == "q_csr_routed":
        return _q_csr_routed(jm, inp, *rest)
    if kind == "q_csr_routed_ds":
        return _q_csr_routed(jm, inp, *rest, ds=True)
    if kind == "q_serve":
        return _q_serve(jm, inp, *rest)
    raise KeyError(name)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    return start_cluster(tmp_path_factory, *MESH, group="int8")


@pytest.mark.parametrize("case", mb.case_names("int8"))
def test_int8_mesh_case_matches_jax(cluster, case):
    check_case(cluster, case, _expected)
    jm, inp, ranks = cluster
    if case.startswith("q_serve"):  # the int8 params bitwise (check_case: within tol)
        want = _expected(case, jm, inp)
        for key in ("big_q", "big_scale", "big_tscale"):
            if key in want:
                np.testing.assert_array_equal(ranks[0][f"{case}/{key}"],
                                              np.asarray(want[key]), err_msg=key)
    assert np.isfinite(np.concatenate([np.ravel(v) for k, v in ranks[0].items()
                                       if k.startswith(case + "/")])).all()
