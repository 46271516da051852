"""The port's command-line entry point (``python -m
pim_embedding_lookup_tpu_torch.cli``) on the CPU, in subprocesses: the
flags of the JAX package's ``train``, the cases of tests/test_cli.py, the
Criteo dataset branch, and the slice as a whole against the JAX CLI.

The whole-slice test gives both CLIs the same params (JAX params from a
seed, saved as a JAX params-only checkpoint, and copied by
``params_from_jax`` into a port params-only checkpoint) and the same
batches (both generate them from ``--seed`` through the same native
library), then compares what they print: the sparse train step's loss at
2e-4 and the accuracy and AUC of the evaluation at 1e-3, on 4-decimal
prints (the f32 MLPs sum in another order on each side)."""

import argparse
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.cli as jcli
import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu.utils.checkpoint as jckpt
import pim_embedding_lookup_tpu_torch.cli as tcli
from pim_embedding_lookup_tpu.models import DLRM as JDLRM
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu_torch import params_from_jax
from pim_embedding_lookup_tpu_torch.models import DLRM as TDLRM
from pim_embedding_lookup_tpu_torch.utils import checkpoint
from torch_port_native_lib import native_build  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, METRIC_TOL = 2e-4, 1e-3
REPORT = re.compile(r"step (\d+): loss=([-\d.]+) acc=([\d.]+) auc=([\d.na]+)")
EVAL = re.compile(r"accuracy=([\d.]+) auc=([\d.na]+)")


def _env(native=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if native:
        env["PEL_NATIVE_LIB"] = native
    return env


def port_cli(*args, native=None):
    return subprocess.Popen([sys.executable, "-m", "pim_embedding_lookup_tpu_torch.cli", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=_env(native))


def jax_cli(*args, native=None):
    env = _env(native)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PEL_FORCE_CPU"] = "1"
    code = ("import jax; jax.config.update('jax_platforms','cpu');"
            "import sys; sys.argv=['cli']+%r;"
            "from pim_embedding_lookup_tpu.cli import main; main()" % (list(args),))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)


def finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run(*args, **kw):
    return finish(port_cli(*args, "--device=cpu", **kw))


def test_train_flags_match_jax(capsys):
    """``train --help`` lists the JAX CLI's flags, and ``--device``."""
    flags = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        with pytest.raises(SystemExit) as e:
            mod.cmd_train(["--help"])
        assert e.value.code == 0
        flags[name] = set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", capsys.readouterr().out))
    assert "--hot-rebuild-every" in flags["jax"]
    assert flags["port"] == flags["jax"] | {"--device"}


def test_train_random_small():
    r = run("train", "--data-generation=random", "--arch-embedding-size=200-300",
            "--arch-sparse-feature-size=8", "--arch-mlp-bot=4-8-8", "--arch-mlp-top=8-1",
            "--mini-batch-size=16", "--num-batches=6", "--num-indices-per-lookup=2",
            "--test-freq=3")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step 3:" in r.stdout and "auc=" in r.stdout


def test_inference_only():
    r = run("train", "--inference-only", "--data-generation=random",
            "--arch-embedding-size=100-100", "--arch-sparse-feature-size=8",
            "--arch-mlp-bot=4-8", "--arch-mlp-top=4-1", "--mini-batch-size=8",
            "--num-batches=3", "--print-time")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "accuracy=" in r.stdout
    assert "inference:" in r.stdout  # --print-time phase report


def test_train_routed_hot_cache():
    """On one process the routed step needs no routing (as the JAX CLI on
    one device), and ROW_HASH runs on a mesh of one."""
    r = run("train", "--data-generation=random", "--arch-embedding-size=200-9000-20000",
            "--arch-sparse-feature-size=8", "--arch-mlp-bot=4-8-8", "--arch-mlp-top=8-1",
            "--sharding=row_hash", "--mini-batch-size=16", "--num-batches=6",
            "--num-indices-per-lookup=2", "--hybrid", "--routed", "--hot-k=16",
            "--hot-rebuild-every=2", "--test-freq=3")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step 3:" in r.stdout and "auc=" in r.stdout


def test_save_load_roundtrip(tmp_path):
    ckpt = str(tmp_path / "model_ckpt")
    common = ["--data-generation=random", "--arch-embedding-size=100-100",
              "--arch-sparse-feature-size=8", "--arch-mlp-bot=4-8", "--arch-mlp-top=4-1",
              "--mini-batch-size=8", "--num-batches=3"]
    r1 = run("train", *common, f"--save-model={ckpt}")
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert "saved full train state" in r1.stdout  # the sparse path saves the full state
    r2 = run("train", "--inference-only", *common, f"--load-model={ckpt}")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "loaded model" in r2.stdout
    r3 = run("train", *common, f"--load-model={ckpt}")
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert "resumed full train state" in r3.stdout and "at step 3" in r3.stdout


def test_dense_update_and_params_checkpoint(tmp_path):
    """``--embedding-update=dense`` runs ``fit`` and saves params only,
    which an inference run loads."""
    ckpt = str(tmp_path / "params")
    common = ["--arch-embedding-size=100-9000", "--arch-sparse-feature-size=8",
              "--arch-mlp-bot=4-8", "--arch-mlp-top=4-1", "--mini-batch-size=8",
              "--num-batches=4", "--hybrid"]
    r1 = run("train", *common, "--embedding-update=dense", "--optimizer=adagrad",
             "--test-freq=2", f"--save-model={ckpt}")
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert "step 4:" in r1.stdout and f"saved model to {ckpt}" in r1.stdout
    assert checkpoint.saved_meta(ckpt)["state"] == "params"
    r2 = run("train", "--inference-only", *common, f"--load-model={ckpt}")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert f"loaded model from {ckpt}" in r2.stdout and "accuracy=" in r2.stdout


def test_dataset_branch_on_npz(tmp_path):
    rng = np.random.default_rng(0)
    n, path = 120, str(tmp_path / "kaggle.npz")
    np.savez(path, X_int=rng.integers(0, 50, size=(n, 13)),
             X_cat=rng.integers(0, 10_000, size=(n, 26)), y=rng.integers(0, 2, size=n),
             counts=np.array([30, 9000, 4] + [17] * 23))
    r = run("train", "--data-generation=dataset", "--data-set=kaggle",
            f"--processed-data-file={path}", "--arch-sparse-feature-size=8",
            "--mini-batch-size=16", "--test-freq=3", "--hybrid", "--optimizer=adagrad")
    assert r.returncode == 0, r.stderr[-2000:]
    # 102 training rows: 6 full batches, reported on the test split
    assert "step 6:" in r.stdout and "step 9:" not in r.stdout


def test_refusals():
    cases = [(("bench", "--device=cpu", "--config=toy", "--tables-filter=big"), "leaves no table"),
             (("sweep", "--device=cpu"), "--grid"),
             (("train", "--mesh-model=4", "--num-batches=1", "--device=cpu"), "torchrun")]
    if not torch.cuda.is_available():  # the default device is the card: no CPU fallback
        cases.append((("train", "--num-batches=1"), "CUDA is not available"))
    procs = [(port_cli(*args), says) for args, says in cases]
    for proc, says in procs:
        r = finish(proc)
        assert r.returncode != 0 and says in r.stderr, (r.args, r.stderr[-2000:])


def _reports(text):
    return [tuple(float(v) for v in m.groups()) for m in REPORT.finditer(text)]


def test_slice_matches_jax_cli(tmp_path, native_build):
    ns = argparse.Namespace(arch_sparse_feature_size=8, arch_embedding_size="200-9000-20000",
                            arch_mlp_bot="4-8-8", arch_mlp_top="8-1", data_set="")
    jmodel = JDLRM(jcli._build_config(ns), make_mesh(jcfg.MeshConfig(data=1, model=1)),
                   hybrid=True)
    params = jmodel.init(jax.random.PRNGKey(7))
    jpath, tpath = str(tmp_path / "jax_params"), str(tmp_path / "port_params")
    jckpt.save(jpath, params, meta={"collection": jckpt.collection_meta(jmodel.collection),
                                    "state": "params"})
    tmodel = TDLRM(tcli._build_config(ns), hybrid=True, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    params_from_jax(jax.tree.map(np.asarray, params), tmodel)
    checkpoint.save(tpath, checkpoint.model_params(tmodel),
                    meta={"collection": checkpoint.collection_meta(tmodel.collection),
                          "state": "params"})

    common = ["train", "--arch-embedding-size=200-9000-20000", "--arch-sparse-feature-size=8",
              "--arch-mlp-bot=4-8-8", "--arch-mlp-top=8-1", "--mini-batch-size=16",
              "--num-indices-per-lookup=2", "--hybrid", "--mesh-data=1", "--mesh-model=1",
              "--num-batches=6", "--seed=3"]
    train, infer = ["--test-freq=3"], ["--inference-only"]
    procs = {
        ("jax", "train"): jax_cli(*common, *train, f"--load-model={jpath}", native=native_build),
        ("jax", "infer"): jax_cli(*common, *infer, f"--load-model={jpath}", native=native_build),
        ("port", "train"): port_cli(*common, *train, f"--load-model={tpath}", "--device=cpu",
                                    native=native_build),
        ("port", "infer"): port_cli(*common, *infer, f"--load-model={tpath}", "--device=cpu",
                                    native=native_build),
    }
    out = {}
    for key, proc in procs.items():
        r = finish(proc)
        assert r.returncode == 0, f"{key}: {r.stderr[-3000:]}"
        assert "loaded model from" in r.stdout
        out[key] = r.stdout
    got, want = _reports(out["port", "train"]), _reports(out["jax", "train"])
    assert [g[0] for g in got] == [w[0] for w in want] == [3, 6]
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= LOSS_TOL, (g, w)
        np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=METRIC_TOL)
    got = [float(v) for v in EVAL.search(out["port", "infer"]).groups()]
    want = [float(v) for v in EVAL.search(out["jax", "infer"]).groups()]
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_TOL)
