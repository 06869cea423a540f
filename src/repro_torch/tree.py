"""Pytrees of tensors in JAX's order: the port's counterpart of ``jax.tree``.

The training substrate (``optim``, ``checkpoint``, ``convert``) walks trees
of tensors the way the reference walks its pytrees, so that leaves line up
across the two packages: dicts by sorted key, tuples and lists in order,
NamedTuples in field order (``AdamWState`` as (step, m, v), an int8 moment
as (q, scale)), ``None`` as a subtree without leaves. Anything else is a
leaf.

``requires_grad_`` and ``value_and_grad`` train a tree of tensors (the
recommenders' and MeshGraphNet's params) as ``nn.Module.requires_grad_``
and ``jax.value_and_grad`` do.

``reference_layout`` maps the port's objects onto the reference's param
tree: an ``nn.Module`` becomes the nested dict of its parameters by dotted
name, a dict keyed by dotted names (the optimizer's moments of a module)
is nested the same way, and a dict keyed ``"0" .. "L-1"`` (the layers of
``Transformer``) becomes one :class:`Stack` a leaf, the reference's leaf
with its leading L axis, over the per-layer tensors the port holds.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(children, rebuild) of a node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if _is_namedtuple(tree):
        return list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda xs: type(tree)(xs)
    if tree is None:
        return [], lambda xs: None
    return None


def tree_leaves(tree) -> list:
    """The leaves in the reference's flatten order."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[0] for leaf in tree_leaves(child)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``; ``rest`` are trees of the same
    structure down to ``tree``'s leaves, where their whole subtrees are
    passed (``jax.tree.map``'s rule: a gradient leaf meets an int8 moment's
    (q, scale) pair)."""
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    children, rebuild = node
    others = []
    for r in rest:
        got = _children(r)
        if got is None or len(got[0]) != len(children):
            raise ValueError("trees of different structure")
        others.append(got[0])
    return rebuild([tree_map(fn, c, *(o[i] for o in others)) for i, c in enumerate(children)])


def tree_structure(tree) -> str:
    """The tree's shape with every leaf as ``*``: two trees with equal
    structures flatten to leaves that pair up."""
    node = _children(tree)
    if node is None:
        return "*"
    kind = "{" if isinstance(tree, dict) else "("
    keys = sorted(tree) if isinstance(tree, dict) else range(len(node[0]))
    inner = ", ".join(f"{k}: {tree_structure(c)}" if kind == "{" else tree_structure(c)
                      for k, c in zip(keys, node[0]))
    return f"{type(tree).__name__}{kind}{inner}{'}' if kind == '{' else ')'}"


def requires_grad_(tree):
    """``nn.Module.requires_grad_()`` for a tree of tensors: every leaf made
    trainable in place; returns ``tree``."""
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    return tree


def value_and_grad(fn: Callable, params):
    """``jax.value_and_grad(fn, has_aux=True)(params)`` for a tree of
    tensors that require grad: ((loss, aux), grads), the grads a tree of
    ``params``' structure, each in its leaf's dtype. Nothing is
    accumulated into ``.grad``."""
    leaves = tree_leaves(params)
    loss, aux = fn(params)
    grads = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
    return ((loss.detach(), tree_map(lambda t: t.detach(), aux)),
            tree_map(lambda _: next(grads), params))


class Stack:
    """One reference leaf stacked on a leading L axis, held by the port as
    its L per-layer parts (a leaf of the trees here, not a node)."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def reference_layout(tree) -> Any:
    """``tree`` in the reference's layout, with :class:`Stack` leaves where
    the reference stacks layers (the parts are the port's own tensors: no
    copy is made)."""
    if isinstance(tree, nn.Module):
        return reference_layout(_nest(dict(tree.named_parameters())))
    if isinstance(tree, dict):
        if any("." in k for k in tree):
            return reference_layout(_nest(tree))
        if tree and all(k.isdigit() for k in tree):
            n = len(tree)
            if sorted(map(int, tree)) != list(range(n)):
                raise ValueError(f"layer keys {sorted(tree)} are not 0..{n - 1}")
            layers = [reference_layout(tree[str(i)]) for i in range(n)]
            if len({tree_structure(x) for x in layers}) != 1:
                raise ValueError("layers of different structure cannot be stacked")
            return tree_map(lambda *parts: Stack(parts), *layers)
        return {k: reference_layout(v) for k, v in tree.items()}
    node = _children(tree)
    if node is None:
        return tree
    return node[1]([reference_layout(c) for c in node[0]])
