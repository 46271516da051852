"""``interact_dot``'s lower-triangle gather with its own backward
(``models/dlrm.py`` ``_TrilPairs``): a plain write of the pairs' cotangent
into zeros in place of the indexing's accumulating ``index_put_``.  The
gradients equal bit for bit those of the plain indexing formula, agree with
``jax.grad`` of the JAX package's ``interact_dot``, and pass ``gradcheck``;
without a graph to record its forward is the plain indexing, and no node
is made."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pim_embedding_lookup_tpu.models.dlrm import interact_dot as jinteract
from pim_embedding_lookup_tpu_torch.models import interact_dot

# (B, T, D): toy shapes, and the Criteo Kaggle model's 26 tables at dim 16
SHAPES = [(5, 4, 8), (3, 1, 2), (7, 26, 16)]
CASES = [(s, si) for s in SHAPES for si in (False, True)]
IDS = [f"B{b}-T{t}-D{d}-{'self' if si else 'noself'}" for (b, t, d), si in CASES]


def _reference(bot_out, pooled, *, self_interaction):
    """The formula before ``_TrilPairs``: its backward is autograd's own."""
    z = torch.cat([bot_out[:, None, :], pooled], dim=1)
    zz = torch.bmm(z, z.transpose(1, 2))
    nf = z.shape[1]
    li, lj = torch.tril_indices(nf, nf, 0 if self_interaction else -1)
    return torch.cat([bot_out, zz[:, li, lj]], dim=1)


def _inputs(shape, seed, dtype=torch.float32):
    b, t, d = shape
    g = torch.Generator().manual_seed(seed)
    bot = torch.randn(b, d, generator=g, dtype=dtype)
    pooled = torch.randn(b, t, d, generator=g, dtype=dtype)
    return bot, pooled, g


def _grads(fn, bot, pooled, self_interaction, cot):
    bot, pooled = bot.clone().requires_grad_(True), pooled.clone().requires_grad_(True)
    out = fn(bot, pooled, self_interaction=self_interaction)
    gb, gp = torch.autograd.grad(out, (bot, pooled), cot)
    return out.detach(), gb, gp


def _cotangent(shape, self_interaction, g):
    b, t, d = shape
    nf = t + 1
    npairs = nf * (nf + 1) // 2 if self_interaction else nf * (nf - 1) // 2
    return torch.randn(b, d + npairs, generator=g)


@pytest.mark.parametrize("shape,self_interaction", CASES, ids=IDS)
def test_grads_bitwise_the_indexing_formula(shape, self_interaction):
    bot, pooled, g = _inputs(shape, 0)
    cot = _cotangent(shape, self_interaction, g)
    want = _grads(_reference, bot, pooled, self_interaction, cot)
    got = _grads(interact_dot, bot, pooled, self_interaction, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,self_interaction", CASES, ids=IDS)
def test_grads_match_jax_grad(shape, self_interaction):
    bot, pooled, g = _inputs(shape, 1)
    cot = _cotangent(shape, self_interaction, g)
    _, gb, gp = _grads(interact_dot, bot, pooled, self_interaction, cot)

    def vjp(b, p):
        return jnp.sum(jinteract(b, p, self_interaction=self_interaction) * cot.numpy())

    jb, jp = jax.grad(vjp, argnums=(0, 1))(jnp.asarray(bot.numpy()), jnp.asarray(pooled.numpy()))
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 26, 3)], ids=["T4", "T26"])
def test_gradcheck_float64(shape, self_interaction):
    bot, pooled, _ = _inputs(shape, 2, torch.float64)
    assert torch.autograd.gradcheck(
        lambda b, p: interact_dot(b, p, self_interaction=self_interaction),
        (bot.requires_grad_(True), pooled.requires_grad_(True)))


class _Ops(TorchDispatchMode):
    """The ATen operations run inside it, with their arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((func, args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def _accumulating_writes(calls):
    """The ``accumulate`` flag of each ``index_put`` call, in order."""
    out = []
    for func, args, kwargs in calls:
        name = func.__name__
        if "index_put" in name:
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            out.append(bool(acc))
    return out


@pytest.mark.parametrize("self_interaction", [False, True])
def test_backward_writes_without_accumulating(self_interaction):
    """The backward runs one ``index_put`` that does not accumulate, where
    the indexing's own backward accumulates (on CUDA: the sort path)."""
    shape = (4, 6, 8)
    bot, pooled, g = _inputs(shape, 3)
    cot = _cotangent(shape, self_interaction, g)

    def backward_ops(fn):
        b, p = bot.clone().requires_grad_(True), pooled.clone().requires_grad_(True)
        out = fn(b, p, self_interaction=self_interaction)
        with _Ops() as ops:
            torch.autograd.grad(out, (b, p), cot)
        return _accumulating_writes(ops.calls)

    assert backward_ops(interact_dot) == [False]
    assert backward_ops(_reference) == [True]


@pytest.mark.parametrize("shape,self_interaction", CASES, ids=IDS)
def test_forward_bitwise_and_no_node_without_a_graph(shape, self_interaction):
    """Under ``no_grad``, and on inputs that need no gradient, the output
    is bit for bit the plain formula's and no ``_TrilPairs`` node is made;
    with a graph to record, the output is the same and has one."""
    bot, pooled, _ = _inputs(shape, 4)
    want = _reference(bot, pooled, self_interaction=self_interaction)
    with torch.no_grad():
        got = interact_dot(bot.requires_grad_(True), pooled, self_interaction=self_interaction)
    assert got.grad_fn is None and torch.equal(got, want)
    got = interact_dot(bot.detach(), pooled, self_interaction=self_interaction)
    assert got.grad_fn is None and torch.equal(got, want)
    got = interact_dot(bot.requires_grad_(True), pooled, self_interaction=self_interaction)
    assert torch.equal(got.detach(), want)
    assert type(got.grad_fn.next_functions[1][0]).__name__ == "_TrilPairsBackward"
