"""The port held to the JAX suite's cross-product checks on a (data=2,
model=4) gloo cluster: the seeded query-surface fuzz
(tests/test_surface_matrix.py), bf16 storage routed and broadcast
(tests/test_bf16.py:44-72) and int8 params through checkpoints on a
ROW_HASH mesh (tests/test_quantized_collection.py:366-400).

A module fixture starts the 8 CPU processes of the mesh at once
(``python -m pim_embedding_lookup_tpu_torch.surface_battery``, gloo over a
file store, one thread each, no JAX), each running every case of
``surface_battery`` on inputs drawn here with numpy.  Each case is one test
on rank 0's results (every other rank's equal to them bitwise, the
checkpoint cases rank by rank):

  fuzz 0-59  the inputs equal the JAX suite's draw (copied below, with its
             numpy oracle); the lookup matches the oracle at the suite's
             tolerances (1e-4; int8 2e-3) and, for cases 0-11 (the suite's
             own), the JAX package on JAX's (2, 4) CPU mesh at rtol 1e-5 /
             atol 1e-6; routed cases drop nothing.  A case the port's
             planner refuses raises the JAX planner's error, word for word.
  bf16       routed equals broadcast bit for bit, and both equal the JAX
             package's routed lookup exactly, for ROW_HASH, ROW and
             TABLE_WISE.
  ckpt       saved, then restored into a fresh template, bit for bit on
             every rank, one file per model shard; refused with "layout
             mismatch" into a ROW template, and refused into the other
             scale mode's template (different keys) with the ValueError
             that JAX's orbax restore raises there (utils/checkpoint.py:133),
             the template untouched.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import pim_embedding_lookup_tpu.config as jcfg
from pim_embedding_lookup_tpu.ops.ragged import shard_csr as jshard_csr
from pim_embedding_lookup_tpu.parallel import EmbeddingCollection as JColl
from pim_embedding_lookup_tpu.parallel import QuantizedEmbeddingCollection as JQColl
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.utils import checkpoint as jckpt
from pim_embedding_lookup_tpu_torch import surface_battery as sb
from test_torch_port_mesh import TOL, _error_text, _run_cluster

MESH = (2, 4)  # (data, model)
JAX_CASES = 12  # the JAX suite's cases; the rest against the oracle alone

# -- the JAX suite's draw and oracle (tests/test_surface_matrix.py) --------------

ROWISH = [jcfg.ShardingPolicy.ROW, jcfg.ShardingPolicy.ROW_HASH,
          jcfg.ShardingPolicy.TABLE_WISE]
ALL_POLICIES = ROWISH + [jcfg.ShardingPolicy.REPLICATE, jcfg.ShardingPolicy.COLUMN]


def oracle_csr(tables_np, bags, combiner):
    b, t = len(bags[0]), len(bags)
    out = np.zeros((b, t, tables_np[0].shape[1]), np.float32)
    for ti in range(t):
        for bi in range(b):
            ids = bags[ti][bi]
            if not ids:
                continue
            rows = tables_np[ti][ids]
            out[bi, ti] = {
                "sum": rows.sum(0), "mean": rows.mean(0), "max": rows.max(0)
            }[combiner]
    return out


def quant_roundtrip(tables_np, scale_mode):
    out = []
    for t in tables_np:
        if scale_mode == "table":
            am = np.abs(t).max()
            scale = np.full(t.shape[0], am / 127.0 if am > 0 else 1.0, np.float32)
        else:
            absmax = np.abs(t).max(axis=1)
            scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(t / scale[:, None]), -127, 127).astype(np.int8)
        out.append(q.astype(np.float32) * scale[:, None])
    return out


def jax_draw(case, nd):
    """The suite's case ``case`` (tests/test_surface_matrix.py:60-124, the
    same draws in the same order)."""
    rng = np.random.default_rng(1000 + case)
    t = int(rng.integers(2, 5))
    dim = int(rng.choice([8, 16, 32]))
    tables = tuple(jcfg.TableConfig(num_rows=int(rng.integers(16, 3000)), dim=dim,
                                    name=f"t{i}") for i in range(t))
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
    tables_np = [rng.standard_normal((tb.num_rows, tb.dim)).astype(np.float32)
                 for tb in tables]
    scale_mode = ("table" if rng.random() < 0.5 else "row") if int8 else None
    max_len = int(rng.integers(2, 7))
    bags = [[rng.integers(0, tb.num_rows, size=rng.integers(0, max_len)).astype(int).tolist()
             for _ in range(b)] for tb in tables]
    shards = nd if data_sharded else 1
    idx, off = jshard_csr(bags, shards, max_len * (b // shards))
    return dict(tables=tables, tables_np=tables_np, int8=int8, packed=packed, policy=policy,
                routed=routed, combiner=combiner, data_sharded=data_sharded,
                scale_mode=scale_mode, bags=bags, idx=idx, off=off)


def jax_collection(jm, d):
    if d["int8"]:
        coll = JQColl.create(d["tables"], jm, d["policy"], packed=d["packed"],
                             scale_mode=d["scale_mode"])
        return coll, coll.quantize_tables(d["tables_np"])
    coll = JColl.create(d["tables"], jm, d["policy"], packed=d["packed"])
    return coll, coll.device_put_tables(d["tables_np"])


def jax_lookup(jm, d):
    coll, params = jax_collection(jm, d)
    kw = dict(combiner=d["combiner"], data_sharded=d["data_sharded"])
    if d["routed"]:
        return coll.lookup_csr(params, jnp.asarray(d["idx"]), jnp.asarray(d["off"]),
                               routed=True, return_stats=True, **kw)
    return coll.lookup_csr(params, jnp.asarray(d["idx"]), jnp.asarray(d["off"]), **kw), None


# -- the cluster ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surface2x4")
    inp, ranks = _run_cluster(tmp, *MESH, group=None, module="surface_battery",
                              inp=sb.make_inputs(MESH[0]))
    return make_mesh(jcfg.MeshConfig(data=MESH[0], model=MESH[1])), inp, ranks, tmp


def _results(ranks, case, same_on_every_rank=True):
    got = [{k[len(case) + 1:]: v for k, v in r.items() if k.startswith(case + "/")}
           for r in ranks]
    assert "error" not in got[0], bytes(got[0]["error"]).decode()
    assert got[0], f"no results for {case}"
    for r, other in enumerate(got[1:], 1):
        assert set(other) == set(got[0]), f"rank {r}"
        if same_on_every_rank:
            for key, val in got[0].items():
                np.testing.assert_array_equal(other[key], val, err_msg=f"rank {r} {key}")
    return got


def _text(arr) -> str:
    return bytes(arr).decode()


@pytest.mark.parametrize("case", range(sb.FUZZ_CASES))
def test_query_surface_fuzz(cluster, case):
    jm, inp, ranks, _ = cluster
    d = jax_draw(case, MESH[0])
    name = f"fuzz-{case}"
    spec = sb.draw_fuzz(case, MESH[0])[0]
    assert (spec["policy"], spec["packed"], spec["routed"], spec["combiner"],
            spec["data_sharded"], spec["scale_mode"], spec["storage"] == "int8") == (
        d["policy"].value, d["packed"], d["routed"], d["combiner"], d["data_sharded"],
        d["scale_mode"], d["int8"])
    for i, t in enumerate(d["tables_np"]):
        np.testing.assert_array_equal(inp[f"{name}/table{i}"], t)
    np.testing.assert_array_equal(inp[f"{name}/idx"], d["idx"])
    np.testing.assert_array_equal(inp[f"{name}/off"], d["off"])

    got = _results(ranks, name)[0]
    if "error_text" in got:  # refused by the planner: as JAX's planner refuses it
        assert d["policy"] == jcfg.ShardingPolicy.COLUMN and d["packed"]
        assert _text(got["error_text"]) == _error_text(lambda: jax_collection(jm, d))
        return
    if d["routed"]:
        assert int(got["dropped"]) == 0, f"case {case}: unexpected drops"
    else:
        assert "dropped" not in got
    if d["int8"]:
        oracle_tables, tol = quant_roundtrip(d["tables_np"], d["scale_mode"]), 2e-3
    else:
        oracle_tables, tol = d["tables_np"], 1e-4
    np.testing.assert_allclose(got["out"], oracle_csr(oracle_tables, d["bags"], d["combiner"]),
                               rtol=tol, atol=tol, err_msg=f"case {case}: {spec}")
    if case < JAX_CASES:
        want, dropped = jax_lookup(jm, d)
        np.testing.assert_allclose(got["out"], np.asarray(want), **TOL)
        if dropped is not None:
            assert int(dropped) == int(got["dropped"]) == 0


@pytest.mark.parametrize("policy", sb.BF16_POLICIES)
def test_bf16_routed_equals_broadcast(cluster, policy):
    jm, inp, ranks, _ = cluster
    got = _results(ranks, f"bf16-{policy}")[0]
    np.testing.assert_array_equal(got["routed"], got["broadcast"])
    assert int(got["dropped"]) == 0
    tabs = tuple(jcfg.TableConfig(num_rows=n, dim=16, name=f"t{i}")
                 for i, n in enumerate(sb.BF16_ROWS))
    coll = JColl.create(tabs, jm, jcfg.ShardingPolicy(policy))
    fused = coll.device_put_tables(
        [inp[f"bf16/table{i}"] for i in range(len(tabs))]).astype(jnp.bfloat16)
    routed = coll.lookup_routed(fused, jnp.asarray(inp["bf16/idx"]),
                                jnp.asarray(inp["bf16/mask"]), batch_size=sb.BF16_BATCH)
    np.testing.assert_array_equal(got["routed"], np.asarray(routed))


def _ckpt(cluster, mode):
    _, _, ranks, tmp = cluster
    return _results(ranks, f"ckpt-{mode}", same_on_every_rank=False), tmp / f"ckpt_{mode}"


@pytest.mark.parametrize("mode", sb.SCALE_MODES)
def test_int8_checkpoint_round_trip(cluster, mode):
    got, path = _ckpt(cluster, mode)
    keys = {"q", "tscale"} if mode == "table" else {"q", "scale"}
    assert sorted(os.listdir(path)) == [f"model{m}-of-{MESH[1]}.pt"
                                        for m in range(MESH[1])] + ["pim_layout.json"]
    for r, res in enumerate(got):
        assert {k[len("saved_"):] for k in res if k.startswith("saved_")} == keys
        for k in keys:
            assert res[f"saved_{k}"].dtype == (np.int8 if k == "q" else np.float32)
            np.testing.assert_array_equal(res[f"restored_{k}"], res[f"saved_{k}"],
                                          err_msg=f"rank {r} {k}")
        assert res["restored_in_place"]
    for r in range(MESH[1], len(got)):  # both data rows of a model column hold its shard
        np.testing.assert_array_equal(got[r]["saved_q"], got[r - MESH[1]]["saved_q"])


@pytest.mark.parametrize("mode", sb.SCALE_MODES)
def test_int8_checkpoint_refuses_a_row_layout(cluster, mode):
    got, _ = _ckpt(cluster, mode)
    for res in got:
        text = _text(res["layout_error_text"])
        assert text.startswith("ValueError: ") and "layout mismatch" in text
        assert res["layout_template_kept"]


@pytest.mark.parametrize("mode", sb.SCALE_MODES)
def test_int8_checkpoint_refuses_the_other_scale_mode(cluster, mode, tmp_path):
    got, _ = _ckpt(cluster, mode)
    other = sb.SCALE_MODES[1 - sb.SCALE_MODES.index(mode)]
    missing = "tscale" if other == "table" else "scale"
    for res in got:
        text = _text(res["scale_mode_error_text"])
        assert text.startswith("ValueError: ") and repr(missing) in text
        assert res["scale_mode_template_kept"]
    # JAX: the layout fingerprints are equal, and orbax refuses the tree
    jm = cluster[0]
    inp = cluster[1]
    tabs = tuple(jcfg.TableConfig(num_rows=n, dim=16, name=f"t{i}")
                 for i, n in enumerate(sb.CKPT_ROWS))
    host = [inp[f"ckpt/table{i}"] for i in range(len(tabs))]
    coll = JQColl.create(tabs, jm, jcfg.ShardingPolicy.ROW_HASH, packed=True,
                         scale_mode=mode)
    jckpt.save(str(tmp_path / "q"), coll.quantize_tables(host),
               meta=jckpt.collection_meta(coll))
    ocoll = JQColl.create(tabs, jm, jcfg.ShardingPolicy.ROW_HASH, packed=True,
                          scale_mode=other)
    assert jckpt.collection_meta(ocoll) == jckpt.collection_meta(coll)
    with pytest.raises(ValueError, match="tree structures do not match"):
        jckpt.restore(str(tmp_path / "q"), ocoll.quantize_tables(host),
                      expect_meta=jckpt.collection_meta(ocoll))
