"""The port's int8 capacity mode and fixed-point numerics against the JAX
package, on the CPU, from the same numpy inputs: ``ops.quantized``,
``ops.fixedpoint``, ``QuantizedEmbeddingCollection`` (params bit for bit,
every lookup dispatch in both scale modes, the row-shard bodies of M = 4
reduced by hand with no process group), the int8 hybrid and
``quantize_dlrm_embeddings`` on a toy DLRM, the bucketed CSR dispatch, and
``quantized_params_from_jax``.

Tolerances: int8 params, scales and fixed-point sums are compared bitwise
(both sides run the same f32 divisions and round half to even).  Pooled
outputs add the same f32 values in another order: rtol 1e-6 / atol 1e-6
on one device, rtol 1e-5 / atol 1e-6 where shards' partials are summed (as
``test_torch_port_shards.py``); logits of the toy DLRM at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.models import DLRM as JDLRM
from pim_embedding_lookup_tpu.models import quantize_dlrm_embeddings as jquantize
from pim_embedding_lookup_tpu.ops import fixedpoint as jfp
from pim_embedding_lookup_tpu.ops import quantized as jq
from pim_embedding_lookup_tpu.ops.ragged import pack_bags, shard_csr
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.bucketed import lookup_csr_bucketed as jbucketed
from pim_embedding_lookup_tpu.parallel.hybrid import HybridEmbeddingCollection as JHybrid
from pim_embedding_lookup_tpu.parallel.hybrid import (
    init_accumulator_hybrid as j_init_acc,
    sparse_update_hybrid as j_update,
    sparse_update_hybrid_csr as j_update_csr,
)
from pim_embedding_lookup_tpu.parallel.quantized_collection import (
    QuantizedEmbeddingCollection as JQColl,
)
from pim_embedding_lookup_tpu_torch import DLRM, params_from_jax, quantize_dlrm_embeddings
from pim_embedding_lookup_tpu_torch.convert import quantized_params_from_jax
from pim_embedding_lookup_tpu_torch.ops import fixedpoint as tfp
from pim_embedding_lookup_tpu_torch.ops import quantized as tq
from pim_embedding_lookup_tpu_torch.ops.ragged import pack_length_buckets, plan_length_buckets
from pim_embedding_lookup_tpu_torch.parallel.bucketed import lookup_csr_bucketed
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection as TColl
from pim_embedding_lookup_tpu_torch.parallel.collection import (
    _csr_finish,
    _csr_rowshard_pool,
    _finish_combiner,
    _rowshard_pooled_lookup,
    shard_accumulator,
    shard_storage,
)
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    HybridEmbeddingCollection as THybrid,
    sparse_update_hybrid,
    sparse_update_hybrid_csr,
)
from pim_embedding_lookup_tpu_torch.parallel.mesh import PortMesh
from pim_embedding_lookup_tpu_torch.parallel.planner import plan
from pim_embedding_lookup_tpu_torch.parallel.quantized_collection import (
    QuantizedEmbeddingCollection as TQColl,
)

CPU = torch.device("cpu")
M = 4
ROWS = (100, 1000, 37, 4000)
DIM = 16
B, L = 16, 5
POISON = 1 << 30  # CSR padding ids
TOL = dict(rtol=1e-6, atol=1e-6)
SHARD_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("table", "row")
POLICIES = ("replicate", "row", "row_hash", "table_wise")
ROWISH = ("row", "row_hash", "table_wise")


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=M))


@pytest.fixture(scope="module")
def jmesh1():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows=ROWS):
    return tuple(mod.TableConfig(num_rows=n, dim=DIM, name=f"t{i}") for i, n in enumerate(rows))


def _host(seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal((n, DIM)).astype(np.float32) for n in rows]
    host[1][7] = 0.0  # a zero row: scale 1, no 0/0
    return rng, host


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _queries(rng, rows=ROWS):
    """A dense-wire query (multi-hot, masked, bag 0 all masked) and a CSR
    query (ragged, empty bags, POISON padding)."""
    idx = np.stack([rng.integers(0, n, B * L) for n in rows]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    mask[:, :L] = False
    bags = [[rng.integers(0, n, size=rng.integers(0, 6)).tolist() for _ in range(B)]
            for n in rows]
    cidx, coff = shard_csr(bags, 1, 8 * B, pad_index=POISON)
    return idx, mask, cidx, coff, bags


def _tparams(params_np):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params_np.items()}


# -- ops.quantized and ops.fixedpoint ---------------------------------------------


def test_quantize_rowwise_and_bag_match_jax():
    """tests/test_ops.py's int8 case: codes and scales bitwise (a zero row
    included), the pooled bags at rtol 1e-6."""
    rng = np.random.default_rng(0)
    n, d, b = 300, 16, 24
    table = rng.standard_normal((n, d)).astype(np.float32)
    table[5] = 0.0
    bags = [rng.integers(0, n, size=6).tolist() for _ in range(b)]
    indices, offsets = pack_bags(bags, capacity=b * 6 + 5, pad_index=0)
    jqt, js = jq.quantize_rowwise(jnp.asarray(table))
    tqt, ts = tq.quantize_rowwise(torch.from_numpy(table))
    assert tqt.dtype == torch.int8 and ts.shape == (n,)
    np.testing.assert_array_equal(tqt.numpy(), np.asarray(jqt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[5].item() == 1.0
    want = jq.embedding_bag_quantized(jqt, js, jnp.asarray(indices), jnp.asarray(offsets),
                                      batch_size=b)
    got = tq.embedding_bag_quantized(tqt, ts, torch.from_numpy(indices),
                                     torch.from_numpy(offsets), batch_size=b)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dequantize_rows_matches_jax():
    """Values on the quantization grid round-trip exactly, as in JAX."""
    rng = np.random.default_rng(0)
    table = (rng.integers(-127, 128, size=(20, 8)) / 127.0).astype(np.float32)
    table[:, 0] = 1.0
    q, s = tq.quantize_rowwise(torch.from_numpy(table))
    jqt, js = jq.quantize_rowwise(jnp.asarray(table))
    got = tq.dequantize_rows(q, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.dequantize_rows(jqt, js)))
    np.testing.assert_allclose(got.numpy(), table, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["small", "wraps"])
def test_fixed_point_matches_jax(case):
    """Raw int32 sums bitwise, including sums that wrap past 2**31, and
    the decoded output (tests/test_ops.py's fixed-point case)."""
    rng = np.random.default_rng(1)
    n, d, b = 200, 16, 32
    hi = 0.2 if case == "small" else 2.0  # |x| * 1e9 up to 2e9: sums of 8 wrap
    table = rng.uniform(-hi, hi, size=(n, d)).astype(np.float32)
    bags = [rng.integers(0, n, size=8).tolist() for _ in range(b)]
    indices, offsets = pack_bags(bags, capacity=b * 8 + 3, pad_index=0)
    ji = jfp.encode(jnp.asarray(table))
    ti = tfp.encode(torch.from_numpy(table))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    args_j = (ji, jnp.asarray(indices), jnp.asarray(offsets))
    args_t = (ti, torch.from_numpy(indices), torch.from_numpy(offsets))
    raw = tfp.embedding_bag_fixed_point(*args_t, batch_size=b, decode_output=False)
    want_raw = np.asarray(jfp.embedding_bag_fixed_point(*args_j, batch_size=b,
                                                        decode_output=False))
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), want_raw)
    exact = np.stack([np.asarray(ji)[bag].astype(np.int64).sum(0) for bag in bags])
    wrapped = exact.astype(np.int32)
    np.testing.assert_array_equal(raw.numpy(), wrapped)
    assert (case == "wraps") == bool((exact != wrapped).any())
    out = tfp.embedding_bag_fixed_point(*args_t, batch_size=b)
    want = jfp.embedding_bag_fixed_point(*args_j, batch_size=b)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-7)
    np.testing.assert_array_equal(tfp.decode(raw).numpy(), np.asarray(jfp.decode(want_raw)))
    assert tfp.SCALE == jfp.SCALE


# -- QuantizedEmbeddingCollection: params ---------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_quantize_tables_bitwise(jmesh, policy, packed, mode):
    _, host = _host(POLICIES.index(policy))
    tc = TQColl(plan(_tables(tcfg), M, tcfg.ShardingPolicy(policy), packed), CPU,
                scale_mode=mode)
    jc = JQColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy(policy), packed=packed,
                       scale_mode=mode)
    got, want = tc.host_params(host), _np(jc.quantize_tables(host))
    assert set(got) == set(want) == {"q", "tscale" if mode == "table" else "scale"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# "table" mode's per-table absmax on a row-sharded mesh takes a pmax, which
# needs a process group: the gloo battery's q_serve cases hold it against JAX
@pytest.mark.parametrize("policy,mode", [(p, m) for p in POLICIES for m in MODES
                                         if m == "row" or p == "replicate"])
def test_quantize_storage_matches_quantize_tables(policy, mode):
    """Quantizing each shard of the f32 storage where it lies gives the
    params ``quantize_tables`` gives for the same tables, bit for bit, even
    with garbage in the rows outside every table."""
    _, host = _host(40 + POLICIES.index(policy))
    lay = plan(_tables(tcfg), M, tcfg.ShardingPolicy(policy), True)
    fused = TColl(lay, CPU).fused_host_array(host).reshape(-1, DIM).copy()
    inside = np.zeros(lay.total_rows, bool)
    for off, n in zip(lay.row_offsets, lay.table_rows):
        inside[off:off + n] = True
    if policy == "row_hash":
        inside = inside[TColl(lay, CPU)._row_hash_perm()]
    assert not inside.all()
    fused[~inside] = 5.0  # rows outside every table: not read as data
    fused = fused.reshape(lay.storage_rows, lay.storage_width)
    want = TQColl(lay, CPU, scale_mode=mode).host_params(host)
    shards = range(M) if policy != "replicate" else [0]
    parts = [TQColl(lay, CPU, PortMesh(1, M, CPU, s, {}), mode).quantize_storage(
        torch.from_numpy(np.ascontiguousarray(shard_storage(lay, s, fused))))
        for s in shards]
    got = {k: torch.cat([p[k] for p in parts]).numpy() for k in ("q", "scale")
           if k in parts[0]}
    if mode == "table":
        got["tscale"] = parts[0]["tscale"].numpy()
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ["replicate", "row_hash", "table_wise"])
def test_quantized_params_from_jax(jmesh, policy, mode):
    """Each model shard's params, cut from JAX's global tree, equal the
    shard JAX places on that shard's device: q like the storage, scale
    (strided under ROW_HASH) like the accumulator."""
    _, host = _host(5)
    lay = plan(_tables(tcfg), M, tcfg.ShardingPolicy(policy), True)
    jc = JQColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy(policy), packed=True,
                       scale_mode=mode)
    jp = jc.quantize_tables(host)
    devices = list(jmesh.devices.reshape(-1))
    for s in range(M):
        tc = TQColl(lay, CPU, PortMesh(1, M, CPU, s, {}), mode)
        got = quantized_params_from_jax(tc, _np(jp))
        assert set(got) == set(jp)
        for key, arr in jp.items():
            on_s = [x for x in arr.addressable_shards if x.device == devices[s]]
            want = np.asarray(on_s[0].data if on_s else arr)  # tscale: one device
            np.testing.assert_array_equal(got[key].numpy(), want, err_msg=f"{key} shard {s}")


@pytest.mark.parametrize("mode", MODES)
def test_init_bounds_and_scales(jmesh, mode):
    """Codes in [-127, 127]; the analytic scales equal JAX's init scales
    bitwise (they do not depend on the key); the two modes give the same
    lookups at init (tests/test_quantized_collection.py:80-117)."""
    import jax

    lay = plan(_tables(tcfg), M, tcfg.ShardingPolicy.ROW_HASH, True)
    jc = JQColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy.ROW_HASH, packed=True,
                       scale_mode=mode)
    jp = _np(jc.init(jax.random.PRNGKey(0)))
    params = [TQColl(lay, CPU, PortMesh(1, M, CPU, s, {}), mode).init(
        torch.Generator().manual_seed(0)) for s in range(M)]
    q = torch.cat([p["q"] for p in params])
    assert q.dtype == torch.int8 and q.shape == (lay.storage_rows, 128)
    assert q.min() >= -127 and q.max() <= 127 and q.float().std() > 50
    if mode == "row":
        s = torch.cat([p["scale"] for p in params]).numpy()
        assert s.shape == (lay.total_rows,)
    else:
        s = params[0]["tscale"].numpy()
        assert s.shape == (len(ROWS),)
    np.testing.assert_array_equal(s, jp["scale" if mode == "row" else "tscale"])
    assert (s > 0).all() and s.max() <= 1.0 / 127 + 1e-9


def test_init_modes_identical():
    rng = np.random.default_rng(3)
    b, l = 8, 3
    idx = torch.from_numpy(np.stack([rng.integers(0, n, b * l) for n in ROWS]).astype(np.int32))
    mask = torch.ones(idx.shape, dtype=torch.bool)
    outs = []
    for mode in MODES:
        tc = TQColl.create(_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, scale_mode=mode,
                           device="cpu")
        outs.append(tc.lookup(tc.init(torch.Generator().manual_seed(7)), idx, mask,
                              batch_size=b))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-7)


# -- lookups ------------------------------------------------------------------------


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("mode", MODES)
def test_replicate_lookup_matches_jax(jmesh1, mode, wire, combiner):
    rng, host = _host(11)
    idx, mask, cidx, coff, _ = _queries(rng)
    tc = TQColl.create(_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, scale_mode=mode,
                       device="cpu")
    jc = JQColl.create(_tables(jcfg), jmesh1, jcfg.ShardingPolicy.REPLICATE,
                       scale_mode=mode)
    tp, jp = tc.quantize_tables(host), jc.quantize_tables(host)
    assert tp["q"].dtype == torch.int8 and tp["q"].device == CPU
    if wire == "dense":
        got = tc.lookup(tp, torch.from_numpy(idx), torch.from_numpy(mask), batch_size=B,
                        combiner=combiner)
        want = jc.lookup(jp, jnp.asarray(idx), jnp.asarray(mask), batch_size=B,
                         combiner=combiner)
    else:
        got = tc.lookup_csr(tp, torch.from_numpy(cidx), torch.from_numpy(coff),
                            combiner=combiner)
        want = jc.lookup_csr(jp, jnp.asarray(cidx), jnp.asarray(coff), combiner=combiner)
    assert got.shape == (B, len(ROWS), DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _shard_dicts(lay, params_np):
    """Each model shard's int8 dict storage, as the shared dispatches read
    it ("table" mode's tscale stays out)."""
    out = []
    for s in range(M):
        st = {"q": torch.from_numpy(np.ascontiguousarray(
            shard_storage(lay, s, params_np["q"])))}
        if "scale" in params_np:
            st["scale"] = torch.from_numpy(np.ascontiguousarray(
                shard_accumulator(lay, s, params_np["scale"])))
        out.append(st)
    return out


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ROWISH)
def test_row_shard_bodies_match_jax(jmesh, policy, mode, wire, combiner):
    """The per-shard bodies of M = 4 on int8 storage, the partials reduced
    by hand (summed, maxed for MAX), finished and scaled, against the JAX
    collection on a (1, 4) mesh."""
    rng, host = _host(20 + ROWISH.index(policy))
    idx, mask, cidx, coff, _ = _queries(rng)
    lay = plan(_tables(tcfg), M, tcfg.ShardingPolicy(policy), True)
    tc = TQColl(lay, CPU, scale_mode=mode)
    pnp = tc.host_params(host)
    shards = _shard_dicts(lay, pnp)
    kw = dict(num_shards=M, rows_per_shard=lay.rows_per_shard,
              strided=lay.policy == tcfg.ShardingPolicy.ROW_HASH)
    if wire == "dense":
        g, keep = tc.globalize(torch.from_numpy(idx)), torch.from_numpy(mask)
        parts = [_rowshard_pooled_lookup(st, DIM, g, keep, L, combiner, shard=s, **kw)
                 for s, st in enumerate(shards)]
    else:
        g, off = tc.globalize(torch.from_numpy(cidx)).contiguous(), torch.from_numpy(coff)
        parts = [_csr_rowshard_pool(st, DIM, g, off, B, combiner, shard=s, **kw)
                 for s, st in enumerate(shards)]
    stacked = torch.stack(parts)
    pooled = stacked.amax(dim=0) if combiner == "max" else stacked.sum(dim=0)
    if wire == "dense":
        pooled = pooled if combiner == "sum" else _finish_combiner(combiner, L, pooled, keep)
    else:
        pooled = _csr_finish(combiner, pooled, off)
    got = tc._apply_tscale(_tparams(pnp), pooled)
    jc = JQColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy(policy), packed=True,
                       scale_mode=mode)
    jp = jc.quantize_tables(host)
    if wire == "dense":
        want = jc.lookup(jp, jnp.asarray(idx), jnp.asarray(mask), batch_size=B,
                         combiner=combiner)
    else:
        want = jc.lookup_csr(jp, jnp.asarray(cidx), jnp.asarray(coff), combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SHARD_TOL)


def test_column_refused_with_jax_text(jmesh):
    with pytest.raises(ValueError) as want:
        JQColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy.COLUMN)
    with pytest.raises(ValueError) as got:
        TQColl.create(_tables(tcfg), tcfg.ShardingPolicy.COLUMN,
                      mesh=PortMesh(1, M, CPU, 0, {}))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="scale_mode"):
        TQColl.create(_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, scale_mode="rows",
                      device="cpu")


# -- the int8 hybrid and quantize_dlrm_embeddings -----------------------------------

HYB_ROWS = (50, 40_000, 300, 60_000)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_hybrid_matches_jax(jmesh1, mode):
    """The hybrid with an int8 big set on both wires against JAX's, and its
    sparse updates refused with the JAX package's errors."""
    rng, host = _host(8, HYB_ROWS)
    tables_t, tables_j = _tables(tcfg, HYB_ROWS), _tables(jcfg, HYB_ROWS)
    th = THybrid.create(tables_t, tcfg.ShardingPolicy.REPLICATE, device="cpu",
                        quantized_big=True, int8_scale_mode=mode)
    jh = JHybrid.create(tables_j, jmesh1, jcfg.ShardingPolicy.REPLICATE,
                        quantized_big=True, int8_scale_mode=mode)
    assert th._big_quantized and th.big.scale_mode == mode
    tp, jp = th.device_put_tables(host), jh.device_put_tables(host)
    np.testing.assert_array_equal(tp["big"]["q"].numpy(), np.asarray(jp["big"]["q"]))
    idx, mask, cidx, coff, _ = _queries(rng, HYB_ROWS)
    got = th.lookup(tp, torch.from_numpy(idx), torch.from_numpy(mask), batch_size=B)
    want = jh.lookup(jp, jnp.asarray(idx), jnp.asarray(mask), batch_size=B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = th.lookup_csr(tp, torch.from_numpy(cidx), torch.from_numpy(coff), combiner="mean")
    want = jh.lookup_csr(jp, jnp.asarray(cidx), jnp.asarray(coff), combiner="mean")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    g = rng.standard_normal((B, len(HYB_ROWS), DIM)).astype(np.float32)
    f32 = JHybrid.create(tables_j, jmesh1, jcfg.ShardingPolicy.REPLICATE)
    for jfn, tfn, q in ((j_update, sparse_update_hybrid, (idx, mask)),
                        (j_update_csr, sparse_update_hybrid_csr, (cidx, coff))):
        with pytest.raises(ValueError, match="inference-only") as want_err:
            jfn(jh, jp, j_init_acc(f32), *map(jnp.asarray, q), jnp.asarray(g), lr=0.1)
        with pytest.raises(ValueError) as got_err:
            tfn(th, tp, {"small": None, "big": None}, *map(torch.from_numpy, q),
                torch.from_numpy(g), lr=0.1)
        assert str(got_err.value) == str(want_err.value)


DLRM_TABLES = (60, 20_000, 300)


def _dlrm_pair(jmesh1, hybrid):
    """The toy DLRM of tests/test_quantize_serving.py in JAX (its init) and
    in the port with the same weights."""
    import jax

    jc = jcfg.DLRMConfig(dense_dim=4, mlp_bot=(8, 16), mlp_top=(8, 1),
                         tables=_tables(jcfg, DLRM_TABLES))
    tcfg_ = tcfg.DLRMConfig(dense_dim=4, mlp_bot=(8, 16), mlp_top=(8, 1),
                            tables=_tables(tcfg, DLRM_TABLES))
    jm = JDLRM(jc, jmesh1, jcfg.ShardingPolicy.REPLICATE, hybrid=hybrid)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = DLRM(tcfg_, tcfg.ShardingPolicy.REPLICATE, hybrid=hybrid, device="cpu",
              generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    params_from_jax(tree, tm)
    return jm, jp, tm


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hybrid", [False, True])
def test_quantize_dlrm_embeddings_matches_jax(jmesh1, hybrid, mode):
    """Serving params bitwise, int8 logits at 1e-5 against JAX's int8
    logits and within the JAX test's bound of the f32 logits; the small
    set unchanged; idempotent on an already quantized hybrid."""
    jm, jp, tm = _dlrm_pair(jmesh1, hybrid)
    rng = np.random.default_rng(0)
    b, l = 16, 2
    dense = rng.standard_normal((b, 4)).astype(np.float32)
    idx = np.stack([rng.integers(0, n, b * l) for n in DLRM_TABLES]).astype(np.int32)
    mask = np.ones(idx.shape, bool)
    jcoll, jserve = jquantize(jm, jp, scale_mode=mode)
    tcoll, tserve = quantize_dlrm_embeddings(tm, scale_mode=mode)
    jemb = jserve["emb"]
    tbig, jbig = (tserve["big"], jemb["big"]) if hybrid else (tserve, jemb)
    assert set(tbig) == set(jbig)
    for key in jbig:
        np.testing.assert_array_equal(tbig[key].numpy(), np.asarray(jbig[key]), err_msg=key)
    if hybrid:
        assert tserve["small"] is tm.emb_small  # the small set stays as trained
    pooled_j = jcoll.lookup(jemb, jnp.asarray(idx), jnp.asarray(mask), batch_size=b)
    want = np.asarray(jm.apply_from_pooled(jserve, jnp.asarray(dense), pooled_j))
    with torch.no_grad():
        pooled = tcoll.lookup(tserve, torch.from_numpy(idx), torch.from_numpy(mask),
                              batch_size=b)
        got = tm.apply_from_pooled(torch.from_numpy(dense), pooled).numpy()
        f32 = tm(torch.from_numpy(dense), torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, f32.numpy(), atol=0.05)
    if hybrid:  # idempotent: an int8 big set is the serving layout already
        stand_in = type("M", (), {"collection": tcoll, "emb_params": lambda self: tserve})()
        again = quantize_dlrm_embeddings(stand_in, scale_mode=mode)
        assert again[0] is tcoll and again[1] is tserve


def test_quantize_dlrm_embeddings_refuses_column(jmesh):
    import jax

    cfg = dict(dense_dim=4, mlp_bot=(8, 16), mlp_top=(8, 1))
    jm = JDLRM(jcfg.DLRMConfig(**cfg, tables=_tables(jcfg, DLRM_TABLES)), jmesh,
               jcfg.ShardingPolicy.COLUMN)
    with pytest.raises(ValueError) as want:
        jquantize(jm, jm.init(jax.random.PRNGKey(0)))
    stand_in = type("M", (), {
        "collection": type("C", (), {"layout": plan(_tables(tcfg, DLRM_TABLES), M,
                                                    tcfg.ShardingPolicy.COLUMN, False)})(),
        "emb_params": lambda self: None})()
    with pytest.raises(ValueError) as got:
        quantize_dlrm_embeddings(stand_in)
    assert str(got.value) == str(want.value)


# -- the bucketed CSR dispatch ------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hybrid", [False, True])
def test_bucketed_csr_on_int8_matches_jax(jmesh1, hybrid, mode):
    rows = HYB_ROWS if hybrid else ROWS
    rng, host = _host(30, rows)
    _, _, cidx, coff, _ = _queries(rng, rows)
    cidx = np.where(cidx == POISON, 0, cidx).astype(np.int32)
    plan_ = plan_length_buckets(coff, bucket_ls=(1, 2), slack=1.0)
    packed = pack_length_buckets(cidx, coff, plan_)
    if hybrid:
        tc = THybrid.create(_tables(tcfg, rows), tcfg.ShardingPolicy.REPLICATE, device="cpu",
                            quantized_big=True, int8_scale_mode=mode)
        jc = JHybrid.create(_tables(jcfg, rows), jmesh1, jcfg.ShardingPolicy.REPLICATE,
                            quantized_big=True, int8_scale_mode=mode)
        tp, jp = tc.device_put_tables(host), jc.device_put_tables(host)
    else:
        tc = TQColl.create(_tables(tcfg, rows), tcfg.ShardingPolicy.REPLICATE,
                           scale_mode=mode, device="cpu")
        jc = JQColl.create(_tables(jcfg, rows), jmesh1, jcfg.ShardingPolicy.REPLICATE,
                           scale_mode=mode)
        tp, jp = tc.quantize_tables(host), jc.quantize_tables(host)
    got = lookup_csr_bucketed(tc, tp, packed)
    want = jbucketed(jc, jp, packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    direct = tc.lookup_csr(tp, torch.from_numpy(cidx), torch.from_numpy(coff))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)
