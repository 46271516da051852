"""The port's lookup bench on a mesh: 4 gloo processes with torchrun's
environment (``tools/common.launch_local``) against the JAX bench on 4
virtual CPU devices.  Both place the tables on a (1, 4) mesh under
ROW_HASH: the ``layout:`` (and ``ragged CSR:``, ``bucket plan:``) lines
agree field by field, rank 0 alone prints one JSON line with the JAX
bench's keys (``tpu_us_per_iter`` as ``us_per_iter``) and ``device_*``
keys, and the device clock is off (the loop has collectives)."""

import json
import os
import subprocess
import sys

import pytest

from pim_embedding_lookup_tpu_torch.tools import common
from test_torch_port_bench import JAX_RUNNER, REPO, TOY, log_fields

CASES = {
    "float32-no-hybrid-dense": ["--dtype", "float32", "--no-hybrid"],
    "int8-no-hybrid-csr-ragged": ["--dtype", "int8", "--no-hybrid", "--wire", "csr",
                                  "--csr-ragged"],
    "bfloat16-hybrid-big-bucketed-ragged": ["--mxu-threshold", "32", "--wire", "csr-bucketed",
                                            "--csr-ragged"],
}


@pytest.fixture(scope="module")
def jax_bench():
    """{case: {"line", "log"}} of the JAX bench on 4 virtual CPU devices."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    items = [(name, TOY + argv + ["--no-baseline"]) for name, argv in CASES.items()]
    p = subprocess.run([sys.executable, "-c", JAX_RUNNER, json.dumps(items)],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_on_4_processes_lays_out_row_hash_as_jax(jax_bench, case, capsys):
    out = common.launch_local("pim_embedding_lookup_tpu_torch.bench",
                              TOY + CASES[case] + ["--no-baseline"], 4, timeout=300)
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines  # rank 0's JSON line only
    mine = json.loads(lines[0])
    want = dict(jax_bench[case]["line"])
    want["us_per_iter"] = want.pop("tpu_us_per_iter")
    assert set(want) <= set(mine)
    assert all(k.startswith("device_") for k in set(mine) - set(want))
    assert mine["metric"] == want["metric"] and mine["device_mesh"] == [1, 4]
    assert mine["device_us_per_iter"] is None and mine["value"] > 0
    jlog, tlog = log_fields(jax_bench[case]["log"]), log_fields(capsys.readouterr().err)
    assert "layout:" in jlog and tlog == jlog
    if "policy" in dict(jlog["layout:"]):
        assert dict(tlog["layout:"])["policy"] == "ShardingPolicy.ROW_HASH"
