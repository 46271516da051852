"""The port's sharded engine on a (data=2, model=2) gloo cluster against
the JAX package on a mesh of the same shape: the cases, the cluster and the
tolerances of ``test_torch_port_mesh.py`` (which runs them on (data=1,
model=4)), here with two data replicas, so that the data axis's all-gathers,
data-sharded CSR windows and the sum of the dense gradients over the data
axis are exercised."""

import pytest

from pim_embedding_lookup_tpu_torch import mesh_battery as mb
from test_torch_port_mesh import check_case, start_cluster

MESH = (2, 2)  # (data, model)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    return start_cluster(tmp_path_factory, *MESH)


@pytest.mark.parametrize("case", mb.case_names())
def test_mesh_case_matches_jax(cluster, case):
    check_case(cluster, case)
