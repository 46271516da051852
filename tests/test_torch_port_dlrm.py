"""The port's DLRM against the JAX package's, at the Criteo-Kaggle widths
with rows capped, through the parameter converter; the port's entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.models import DLRM as JDLRM
from pim_embedding_lookup_tpu.models.dlrm import bce_loss as jbce
from pim_embedding_lookup_tpu.models.dlrm import interact_dot as jinteract
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu_torch import entry, params_from_jax
from pim_embedding_lookup_tpu_torch.models import DLRM as TDLRM
from pim_embedding_lookup_tpu_torch.models import bce_loss as tbce
from pim_embedding_lookup_tpu_torch.models import interact_dot as tinteract

ROW_CAP = 10_000  # keeps 16 tables in the small set and 10 in the big set


def _capped_kaggle(mod):
    cfg = mod.kaggle_config()
    tables = tuple(mod.TableConfig(num_rows=min(t.num_rows, ROW_CAP), dim=t.dim,
                                   name=t.name) for t in cfg.tables)
    return mod.DLRMConfig(dense_dim=cfg.dense_dim, mlp_bot=cfg.mlp_bot,
                          mlp_top=cfg.mlp_top, tables=tables)


@pytest.fixture(scope="module")
def models():
    jcfg_ = _capped_kaggle(jcfg)
    jmodel = JDLRM(jcfg_, make_mesh(jcfg.MeshConfig(data=1, model=1)),
                   jcfg.ShardingPolicy.REPLICATE, hybrid=True)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = TDLRM(_capped_kaggle(tcfg), tcfg.ShardingPolicy.REPLICATE,
                   hybrid=True, device="cpu", generator=torch.Generator())
    params_from_jax(jax.tree.map(np.asarray, params), tmodel)
    return jmodel, params, tmodel


@pytest.mark.parametrize("masked", [False, True])
def test_logits_match_jax(models, masked):
    jmodel, params, tmodel = models
    assert len(tmodel.collection.small_ids) == 16
    assert len(tmodel.collection.big_ids) == 10
    rng = np.random.default_rng(1)
    b = 32
    dense = rng.random((b, 13), dtype=np.float32)
    idx = np.stack([rng.integers(0, t.num_rows, size=b)
                    for t in tmodel.config.tables]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.8 if masked else np.ones(idx.shape, bool)
    want = np.asarray(jmodel.apply(params, jnp.asarray(dense), jnp.asarray(idx),
                                   jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(dense), torch.from_numpy(idx),
                     torch.from_numpy(mask)).numpy()
    assert got.shape == (b,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_plain_collection_logits_match_jax(rng):
    """Non-hybrid DLRM (one fused collection, multi-hot) at the toy preset."""
    cfg_j, cfg_t = jcfg.toy_config(), tcfg.toy_config()
    jmodel = JDLRM(cfg_j, make_mesh(jcfg.MeshConfig(data=1, model=1)),
                   jcfg.ShardingPolicy.REPLICATE)
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = TDLRM(cfg_t, tcfg.ShardingPolicy.REPLICATE, device="cpu",
                   generator=torch.Generator())
    params_from_jax(jax.tree.map(np.asarray, params), tmodel)
    b, l = 16, 3
    dense = rng.random((b, cfg_t.dense_dim), dtype=np.float32)
    idx = rng.integers(0, 64, size=(cfg_t.num_tables, b * l)).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    want = np.asarray(jmodel.apply(params, jnp.asarray(dense), jnp.asarray(idx),
                                   jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(dense), torch.from_numpy(idx),
                     torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tf32_matmul_is_refused(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        TDLRM(tcfg.toy_config(), device="cpu", generator=torch.Generator())


@pytest.mark.parametrize("self_interaction", [False, True])
def test_interact_dot_matches(rng, self_interaction):
    bot = rng.standard_normal((5, 8)).astype(np.float32)
    pooled = rng.standard_normal((5, 4, 8)).astype(np.float32)
    want = np.asarray(jinteract(jnp.asarray(bot), jnp.asarray(pooled),
                                self_interaction=self_interaction))
    got = tinteract(torch.from_numpy(bot), torch.from_numpy(pooled),
                    self_interaction=self_interaction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bce_loss_matches(rng):
    logits = (rng.standard_normal(64) * 4).astype(np.float32)
    labels = (rng.random(64) < 0.5).astype(np.float32)
    want = float(jbce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tbce(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_entry_on_cpu_gives_finite_logits():
    model, (dense, idx, mask) = entry(device="cpu")
    assert idx.shape == (26, 128) and mask.all()
    with torch.no_grad():
        logits = model(dense, idx, mask)
        probs = model.predict(dense, idx, mask)
    assert logits.shape == (128,) and torch.isfinite(logits).all()
    torch.testing.assert_close(probs, torch.sigmoid(logits))


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
