"""Checkpoint save and restore (``--save-model`` / ``--load-model``), with a
layout fingerprint.

The counterpart of ``pim_embedding_lookup_tpu.utils.checkpoint``.  A state
is a tensor, number, string or None, or a dict, list or tuple of them
(nested): a DLRM's params (``model_params``), or a full sparse train state
with the row-AdaGrad accumulator, the dense optimizer's ``state_dict`` and
the step.  A checkpoint is a directory:

  model<m>-of-<M>.pt  the state of model shard m of M, ``torch.save`` of
                      plain tensors (read back with ``weights_only=True``);
                      on a (data, model) mesh written by the processes of
                      data row 0, each holding its own shard and the
                      replicated leaves; without a mesh ``model0-of-1.pt``
  pim_layout.json     the layout fingerprint, as the JAX package writes it

It is not an orbax checkpoint: the two packages do not read each other's.

The fused storage's order depends on the planner's decision (policy,
lane-pack factor, padded row count, per-table offsets), and two layouts can
share a shape: a contiguous ROW table read as strided ROW_HASH passes every
shape check and returns wrong rows.  So ``save`` writes the fingerprint,
and ``restore`` refuses a checkpoint whose fingerprint, or whose number of
model shards, differs from the current collection's.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any

import torch

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

_META_NAME = "pim_layout.json"
_SHARD_FILE = re.compile(r"model(\d+)-of-(\d+)\.pt$")


def _layout_fingerprint(lay) -> dict:
    return {
        "policy": str(lay.policy.value),
        "pack": int(lay.pack),
        "dim": int(lay.dim),
        "num_shards": int(lay.num_shards),
        "total_rows": int(lay.total_rows),
        "row_offsets": [int(o) for o in lay.row_offsets],
        "table_rows": [int(r) for r in lay.table_rows],
    }


def collection_meta(coll) -> dict:
    """Layout fingerprint of an EmbeddingCollection or
    HybridEmbeddingCollection: the JAX package's dict for the same
    layout."""
    if hasattr(coll, "layout"):
        return {"kind": "collection", "layout": _layout_fingerprint(coll.layout)}
    return {
        "kind": "hybrid",
        "small_ids": [int(i) for i in coll.small_ids],
        "big_ids": [int(i) for i in coll.big_ids],
        "small": _layout_fingerprint(coll.small.layout) if coll.small else None,
        "big": _layout_fingerprint(coll.big.layout) if coll.big else None,
    }


def model_params(model) -> dict:
    """A DLRM's tensors as a state: ``{"emb": model.emb_params(), "bot"/"top":
    [{"w", "b"}, ...]}``, ``w`` in ``nn.Linear``'s [out, in].  The leaves
    are the model's own tensors, so restoring into this tree restores the
    model."""
    return {
        "emb": model.emb_params(),
        **{name: [{"w": lin.weight, "b": lin.bias} for lin in getattr(model, name)]
           for name in ("bot", "top")},
    }


def _plain(state):
    if isinstance(state, torch.Tensor):
        return state.detach()
    if isinstance(state, dict):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_plain(v) for v in state)
    return state


def _place(mesh) -> tuple[int, int]:
    """(model shard, model shards) of this process."""
    return (0, 1) if mesh is None else (mesh.index(MODEL_AXIS), mesh.model)


def _mesh_barrier(mesh) -> None:
    """Return once every process of the mesh has reached this call: a sum
    over the model axis, then over the data axis, waited for."""
    flag = torch.zeros(1, device=mesh.device)
    float(mesh.psum(mesh.psum(flag, MODEL_AXIS), DATA_AXIS))


def save(path: str, state: Any, *, meta: dict | None = None, mesh=None) -> None:
    """Write ``state`` (this process's shard on a ``mesh``, where every
    process of the mesh calls this) and the fingerprint ``meta``
    (``collection_meta`` and what the caller adds)."""
    path = os.path.abspath(path)
    m, shards = _place(mesh)
    primary = mesh is None or (m == 0 and mesh.index(DATA_AXIS) == 0)
    if mesh is None or mesh.index(DATA_AXIS) == 0:
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, f"model{m}-of-{shards}.pt")
        torch.save(_plain(state), target + ".tmp")
        os.replace(target + ".tmp", target)
    if primary:
        for old in glob.glob(os.path.join(path, "model*-of-*.pt")):
            found = _SHARD_FILE.search(old)
            if found and int(found.group(2)) != shards:  # another mesh's save
                os.remove(old)
        meta_path = os.path.join(path, _META_NAME)
        if meta is not None:
            with open(meta_path, "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
        elif os.path.exists(meta_path):
            os.remove(meta_path)
    if mesh is not None:
        _mesh_barrier(mesh)


def saved_meta(path: str) -> dict | None:
    mp = os.path.join(os.path.abspath(path), _META_NAME)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f)


def validate_meta(path: str, expect_meta: dict) -> None:
    """Raise if the checkpoint's layout fingerprint contradicts
    ``expect_meta`` (a match over expect_meta's keys); a checkpoint without
    one passes."""
    found = saved_meta(os.path.abspath(path))
    if found is not None and any(found.get(k) != v for k, v in expect_meta.items()):
        raise ValueError(
            f"checkpoint layout mismatch at {path}: "
            f"{_meta_diff(found, expect_meta)} — the saved fused table's "
            "storage order differs from this collection's plan; rebuild the "
            "collection with the saved layout (policy/pack/shards) or "
            "re-export the checkpoint"
        )


def restore_raw(path: str, *, mesh=None) -> Any:
    """This process's saved state as it was written: tensors on the CPU,
    no template (to pick a sub-tree, e.g. the params out of a full train
    state)."""
    path = os.path.abspath(path)
    m, shards = _place(mesh)
    target = os.path.join(path, f"model{m}-of-{shards}.pt")
    if not os.path.exists(target):
        saved = sorted({int(f.group(2)) for f in map(_SHARD_FILE.search, glob.glob(
            os.path.join(path, "model*-of-*.pt"))) if f})
        if saved:
            raise ValueError(f"checkpoint layout mismatch at {path}: saved over "
                             f"{saved} model shards, this mesh has {shards}")
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(target, map_location="cpu", weights_only=True)


_ABSENT = object()


def _fill(saved, template, where: str):
    """``saved``'s tree with each tensor that ``template`` holds at the same
    path copied into that tensor in place (so it keeps its device and
    shard); leaves the template lacks come back as saved."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint{where}: {type(saved).__name__}, expected a tensor")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"checkpoint{where}: {saved.dtype} {tuple(saved.shape)}, the "
                             f"template holds {template.dtype} {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint{where}: {type(saved).__name__}, expected a dict")
        missing = [k for k in template if k not in saved]
        if missing:
            raise ValueError(f"checkpoint{where} lacks {missing}")
        return {k: _fill(v, template.get(k, _ABSENT), f"{where}[{k!r}]")
                for k, v in saved.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"checkpoint{where}: {saved!r:.80}, expected "
                             f"{len(template)} items")
        return type(template)(_fill(s, t, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved, template)))
    return saved


def pin_like(tree: Any, template: Any) -> Any:
    """Copy every tensor of ``tree`` (host tensors, e.g. from
    ``restore_raw``) into the matching tensor of ``template``, in place;
    returns the template's tree."""
    return _fill(tree, template, "")


def restore(path: str, template: Any, *, expect_meta: dict | None = None,
            mesh=None) -> Any:
    """Restore into ``template``, a state of the saved structure: its
    tensors are overwritten in place; other leaves, and sub-trees the
    template lacks (such as an optimizer's state), come back as saved.

    ``expect_meta``: the current collection's fingerprint
    (``collection_meta``); where the checkpoint carries one, every key of
    ``expect_meta`` must match it.  A checkpoint without one restores with
    no check."""
    if expect_meta is not None:
        validate_meta(path, expect_meta)
    return _fill(restore_raw(path, mesh=mesh), template, "")


def _meta_diff(found: dict, expect: dict) -> str:
    keys = sorted(set(found) | set(expect))
    bad = [k for k in keys if found.get(k) != expect.get(k)]
    return ", ".join(
        f"{k}: saved={found.get(k)!r} vs current={expect.get(k)!r}" for k in bad
    )
