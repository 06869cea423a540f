"""Sharding rules — logical axis names resolved against the active mesh —
and the port's placement of tensors on a mesh of logical positions.

Model code annotates tensors with LOGICAL axes ("batch", "seq", "embed",
"heads", "ffn", "expert", "vocab", "rows", "edges", ...). The rules map
logical axes to mesh axes; anything unmapped is replicated. Without an
active mesh (``repro_torch.core.mesh.use_mesh``) every spec resolves to
replicated, so the same model code serves smoke tests, training and the
dry run. The rules, ``resolve``, ``sanitize_spec``, ``spec`` and
``sanitize_tree`` compute exactly the reference's specs
(``repro.runtime.sharding``).

Default rules target the production mesh (pod, data, model):
    batch  -> (pod, data)     activations/data parallel
    embed  -> model  (FSDP param shard: weights gather per-layer)
    heads/ffn/expert/vocab/rows -> model   (tensor/expert/table parallel)

The port has no SPMD partitioner, so by design it splits the reference's
behaviour four ways:

1. Specs: computed, sanitized and carried as the reference's.
2. Placement: :func:`place` puts each position's block of a tensor on that
   position's device (a :class:`Sharded`); ``runtime.elastic.reshard_tree``,
   ``DataPipeline(mesh=)`` and ``load_checkpoint(shardings=)`` place with it.
   A block is the slice that JAX's ``NamedSharding`` gives the device at
   that mesh position; a position of a replicated axis holds the whole dim.
3. Islands: each of the reference's ``shard_map`` islands runs position by
   position on local blocks, its collectives explicit reductions over the
   positions between two loops (``models.layers``, ``models.recsys``).
4. Everything else computes on global tensors at the mesh's first device:
   :func:`shard` leaves its value as it is, as ``with_sharding_constraint``
   leaves the value of its operand.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.mesh import Mesh, current_mesh
from repro_torch.tree import Stack, tree_map


class P:
    """``jax.sharding.PartitionSpec``: one entry a dim, each None (the dim
    is not split), a mesh axis name, or a tuple of names (split over their
    product, the first axis major). A one-name tuple reads as the name, as
    in JAX. Two specs are equal when their entries are, one by one (so
    ``P("a") != P("a", None)``, as in JAX). A leaf of ``repro_torch.tree``."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else e
            out.append(e)
        self._entries = tuple(out)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self._entries))})"


# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": None,
    "embed": None,  # replicated activations along d_model
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert": "model",
    "vocab": "model",
    "rows": "model",  # embedding-table / dataset rows
    "fsdp": ("pod", "data"),  # parameter sharding axis for ZeRO-3
    "edges": ("pod", "data", "model"),  # GNN edge partitions
    "nodes": None,
}

_local = threading.local()


def current_rules() -> Mapping[str, object]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, object]):
    prev = getattr(_local, "rules", DEFAULT_RULES)
    _local.rules = dict(rules)
    try:
        yield
    finally:
        _local.rules = prev


def _mesh_axis_names() -> tuple[str, ...]:
    mesh = current_mesh()
    return () if mesh is None else tuple(mesh.axis_names)


def resolve(logical: Sequence[str | None]) -> P:
    """Translate logical axes to a spec under the current rules, dropping
    mesh axes that do not exist on the active mesh."""
    names = _mesh_axis_names()
    rules = current_rules()
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
            continue
        tgt = rules.get(ax)
        if tgt is None:
            out.append(None)
        elif isinstance(tgt, tuple):
            present = tuple(t for t in tgt if t in names)
            out.append(present if len(present) > 1 else (present[0] if present else None))
        else:
            out.append(tgt if tgt in names else None)
    return P(*out)


def _mesh_axis_sizes() -> Mapping[str, int]:
    mesh = current_mesh()
    return {} if mesh is None else dict(mesh.shape)


def _axis_product(entry, sizes: Mapping[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(sizes.get(e, 1) for e in entry)
    return sizes.get(entry, 1)


def sanitize_spec(shape: Sequence[int], spec: P, sizes: Mapping[str, int] | None = None) -> P:
    """Drop spec axes whose mesh size does not divide the dim evenly
    (minicpm's odd vocab 122,753, starcoder2's 36 heads over 16): that dim
    is replicated instead. The spec is padded with None to the rank."""
    sizes = _mesh_axis_sizes() if sizes is None else sizes
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(e if dim % _axis_product(e, sizes) == 0 else None
               for dim, e in zip(shape, entries)))


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding constraint by logical axes: ``x`` itself
    (the port computes on the global tensor; see the module docstring)."""
    return x


def spec(*logical: str | None) -> P:
    """The spec of a cell's inputs or outputs."""
    return resolve(logical)


def sanitize_tree(shapes_tree, specs_tree, mesh: Mesh):
    """Per-leaf sanitize_spec over a (shape tree, spec tree) pair. Leaves of
    ``shapes_tree`` are anything with a ``.shape`` (a meta tensor, a
    :class:`~repro_torch.tree.Stack`), each met by the spec at its place
    in ``specs_tree``."""
    sizes = dict(mesh.shape)
    return tree_map(lambda s, sp: sanitize_spec(tuple(s.shape), sp, sizes),
                    shapes_tree, specs_tree)


# ------------------------------------------------------------- placement
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec on a mesh."""

    mesh: Mesh
    spec: P


def _block_slices(shape: Sequence[int], spec: P, mesh: Mesh, coord: tuple) -> tuple:
    """The slice of each dim that the position at ``coord`` holds."""
    out = []
    for dim, entry in zip(shape, list(spec) + [None] * (len(shape) - len(spec))):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        parts, idx = 1, 0
        for ax in axes:
            a = mesh.axis_names.index(ax)
            parts *= mesh.devices.shape[a]
            idx = idx * mesh.devices.shape[a] + coord[a]
        if dim % parts:
            raise ValueError(f"dim {dim} does not split over {parts} positions of {entry!r}; "
                             "sanitize the spec first (sanitize_spec)")
        size = dim // parts
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


class Sharded:
    """A global tensor placed on a mesh: ``blocks[p]`` is the block that the
    position at flat index p (``mesh.devices.flat`` order) holds, on its
    device. ``full()`` gathers the global tensor on the mesh's first
    device."""

    def __init__(self, shape, dtype, spec: P, mesh: Mesh, blocks):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.spec = spec
        self.mesh = mesh
        self.blocks = tuple(blocks)

    def block_at(self, coord: tuple) -> torch.Tensor:
        return self.blocks[int(np.ravel_multi_index(coord, self.mesh.devices.shape))]

    def copy_(self, src: torch.Tensor) -> "Sharded":
        """Write global ``src`` into every block in place."""
        for coord in np.ndindex(self.mesh.devices.shape):
            self.block_at(coord).copy_(src[_block_slices(self.shape, self.spec, self.mesh, coord)])
        return self

    def full(self) -> torch.Tensor:
        out = torch.empty(self.shape, dtype=self.dtype, device=self.mesh.first)
        for coord in np.ndindex(self.mesh.devices.shape):
            out[_block_slices(self.shape, self.spec, self.mesh, coord)] = self.block_at(coord)
        return out

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, {self.dtype}, {self.spec}, {self.mesh!r})"


def place(x, spec: P, mesh: Mesh):
    """Put ``x`` on ``mesh`` under ``spec``: each position's block on its
    device (a view where ``x`` already lies there). ``x`` may be a tensor,
    anything ``torch.as_tensor`` takes, a :class:`Sharded` (gathered
    first), or a :class:`~repro_torch.tree.Stack` (the reference's leaf
    with a leading L axis), placed part by part under the spec's other
    entries; that leading axis is never split. Every split dim must divide
    evenly."""
    if isinstance(x, Stack):
        if len(spec) and spec[0] is not None:
            raise ValueError(f"{spec} splits the stacked layer axis")
        return Stack(place(part, P(*list(spec)[1:]), mesh) for part in x.parts)
    if isinstance(x, Sharded):
        x = x.full()
    x = torch.as_tensor(x)
    if len(spec) > x.ndim:
        raise ValueError(f"{spec} has more entries than the rank {x.ndim}")
    blocks = [x[_block_slices(x.shape, spec, mesh, coord)].to(mesh.devices[coord])
              for coord in np.ndindex(mesh.devices.shape)]
    return Sharded(x.shape, x.dtype, spec, mesh, blocks)


__all__ = ["DEFAULT_RULES", "NamedSharding", "P", "Sharded", "axis_rules", "current_rules",
           "place", "resolve", "sanitize_spec", "sanitize_tree", "shard", "spec"]
