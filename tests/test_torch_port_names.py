"""The port's import surface against the JAX package's: every name that the
JAX package's root ``__init__`` imports, and every name in the ``__all__``
of its ``ops``, ``parallel``, ``models``, ``utils`` and ``data``, imports
from the same subpackage of the port, as the same kind of object (a
module, a class, a function, or a constant of equal value).

Named exceptions:
  ``ops.pallas_embedding_bag_csr`` is ``ops.embedding_bag_csr_sum`` in the
  port (the differentiable CSR bag of kernel K4: a GPU has no Pallas);
  ``parallel.replicated``, ``batch_sharded``, ``row_sharded`` and
  ``col_sharded`` build JAX ``NamedSharding``s and have no torch
  counterpart: the port has no such names.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

import pim_embedding_lookup_tpu as jpkg

SUBPACKAGES = ("ops", "parallel", "models", "utils", "data")
RENAMED = {("ops", "pallas_embedding_bag_csr"): "embedding_bag_csr_sum"}
NO_COUNTERPART = {("parallel", n) for n in
                  ("replicated", "batch_sharded", "row_sharded", "col_sharded")}


def _root_names() -> list[str]:
    """The names the JAX root ``__init__`` binds: its imports and
    ``__version__``."""
    tree = ast.parse(Path(jpkg.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def _cases() -> list[tuple[str, str]]:
    cases = [("", n) for n in _root_names()]
    for sub in SUBPACKAGES:
        mod = importlib.import_module(f"pim_embedding_lookup_tpu.{sub}")
        cases += [(sub, n) for n in mod.__all__]
    return cases


def _module(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}" if sub else pkg)


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return "constant"


def test_the_surface_is_complete():
    cases = _cases()
    assert len(cases) == len(set(cases)) == 69
    assert RENAMED.keys() <= set(cases) and NO_COUNTERPART <= set(cases)


@pytest.mark.parametrize("sub,name", _cases(), ids=lambda x: x or "root")
def test_name_imports_from_the_port(sub, name):
    want = getattr(_module("pim_embedding_lookup_tpu", sub), name)
    port = _module("pim_embedding_lookup_tpu_torch", sub)
    if (sub, name) in NO_COUNTERPART:
        assert _kind(want) == "function" and not hasattr(port, name)
        return
    got = getattr(port, RENAMED.get((sub, name), name))
    assert _kind(got) == _kind(want)
    if _kind(want) == "constant":
        assert got == want
    if _kind(want) == "module":
        assert got.__name__ == want.__name__.replace("pim_embedding_lookup_tpu",
                                                     "pim_embedding_lookup_tpu_torch")


def test_root_version_and_parallel_mesh_names():
    from pim_embedding_lookup_tpu_torch import __version__, config, embedding_bag, ops
    from pim_embedding_lookup_tpu_torch.parallel import (
        DATA_AXIS, MODEL_AXIS, make_mesh, shard_count,
    )

    assert __version__ == "0.1.0" == jpkg.__version__
    assert embedding_bag is ops.embedding_bag and config.MeshConfig
    assert (DATA_AXIS, MODEL_AXIS) == ("data", "model") and shard_count(None) == 1
    assert callable(make_mesh)
