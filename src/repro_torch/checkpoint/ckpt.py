"""Atomic, async checkpoints of training state, in the reference's layout.

Layout (one directory per step), the reference's (``repro.checkpoint``):
    <dir>/step_000123/
        manifest.json   step, leaf count, each leaf's shape and dtype,
                        framework metadata
        arr_<i>.npy     one file per leaf (written via a temp dir + rename
                        for atomicity; partial writes never corrupt)

The leaves are the reference's, in its flatten order (``repro_torch.tree``):
dicts by sorted key, NamedTuples in field order, a port ``Transformer`` and
its moments as the reference's param tree with each layer weight stacked
on a leading L axis. So a checkpoint written by either package opens in
the other. bf16 leaves are stored by their bits as ``uint16`` with
``"bfloat16"`` in the manifest, as the reference stores them.

Async: ``save_checkpoint(..., blocking=False)`` copies every leaf to the
host before it returns (the only sync point; training may then overwrite
its tensors in place) and writes the files on one worker thread.

Restore writes into the template's tensors in place, as
``nn.Module.load_state_dict`` does, and returns the template: a template
on the card takes its checkpoint without a second copy of the state there.
With ``shardings=`` (a tree of ``runtime.sharding.NamedSharding`` or None
over the template's reference layout) a leaf with a sharding comes back
placed on its mesh (``runtime.sharding.Sharded``, one block a position),
whatever mesh wrote it: the elastic restore of the reference. A placed
leaf is saved whole (``Sharded.full()``), so the files stay full arrays.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.runtime.sharding import Sharded, place
from repro_torch.tree import Stack, reference_layout, tree_leaves, tree_map, tree_structure

_executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
_pending: list[concurrent.futures.Future] = []
_lock = threading.Lock()

#: torch dtype -> the reference's dtype name (numpy's, or ml_dtypes' for bf16)
_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
          torch.bool: "bool"}


def host_array(t) -> np.ndarray:
    """A leaf (tensor, :class:`Stack` of tensors, or anything numpy reads) as
    a host numpy array of its own; bf16 as its uint16 bits."""
    if isinstance(t, Stack):
        return np.stack([host_array(p) for p in t.parts])
    if isinstance(t, Sharded):
        t = t.full()
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.to("cpu", copy=True).numpy().view(np.uint16)
        return t.to("cpu", copy=True).numpy()
    return np.array(t)


def dtype_name(t) -> str:
    if isinstance(t, (torch.Tensor, Stack, Sharded)):
        return _NAMES[t.dtype]
    return str(np.asarray(t).dtype)


def to_tensor(a: np.ndarray, dtype_name_: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype (bf16 from bits)."""
    a = np.require(a, requirements=["C", "W"])  # keeps a 0-d array 0-d
    if dtype_name_ == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def fill(dst, src: torch.Tensor) -> None:
    """Copy ``src`` (a CPU tensor of the leaf's reference shape) into the
    leaf ``dst`` in place, cast to its dtype (a :class:`Stack` part by part,
    a placed leaf block by block)."""
    if isinstance(dst, Stack):
        for i, part in enumerate(dst.parts):
            fill(part, src[i])
        return
    with torch.no_grad():
        dst.copy_(src.to(dst.dtype))  # a Sharded's copy_ writes each block


def _check(dst: list, leaves: list, what: str) -> None:
    if len(dst) != len(leaves):
        raise ValueError(f"{what} has {len(leaves)} leaves, template has {len(dst)}")
    for i, (t, (shape, _, _)) in enumerate(zip(dst, leaves)):
        if not isinstance(t, (torch.Tensor, Stack, Sharded)):
            raise TypeError(f"leaf {i}: a template leaf is a tensor, not {type(t).__name__}")
        if tuple(shape) != tuple(t.shape):
            raise ValueError(f"leaf {i}: shape {tuple(shape)} != template {tuple(t.shape)}")


def restore(template: Any, leaves: list, what: str = "the stored tree") -> Any:
    """Write stored leaves into ``template``'s tensors in place and return
    it. ``leaves`` are (shape, dtype name, load) in the reference's flatten
    order, ``load()`` giving the host array; the count and every shape are
    checked before anything is written."""
    dst = tree_leaves(reference_layout(template))
    _check(dst, leaves, what)
    for t, (_, name, load) in zip(dst, leaves):
        fill(t, to_tensor(load(), name))
    return template


def restore_sharded(template: Any, leaves: list, shardings: Any,
                    what: str = "the stored tree") -> Any:
    """:func:`restore` with ``shardings``, a tree over the template's
    reference layout whose leaves are ``NamedSharding`` or None: a leaf
    with a sharding is placed on its mesh in the template leaf's dtype (a
    :class:`Stack` part by part), one without is restored in place.
    Returns the reference layout with those leaves."""
    layout = reference_layout(template)
    _check(tree_leaves(layout), leaves, what)
    it = iter(leaves)

    def one(t, shd):
        _, name, load = next(it)
        src = to_tensor(load(), name)
        if shd is None:
            fill(t, src)
            return t
        if isinstance(t, Stack):
            src = Stack(list(src.to(t.dtype)))
        else:
            src = src.to(t.dtype)
        return place(src, shd.spec, shd.mesh)

    return tree_map(one, layout, shardings)


def save_checkpoint(
    directory: str | os.PathLike,
    step: int,
    tree: Any,
    extra_meta: dict | None = None,
    blocking: bool = True,
) -> pathlib.Path:
    """Write an atomic checkpoint; returns the final path."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"

    layout = reference_layout(tree)
    leaves = tree_leaves(layout)
    names = [dtype_name(x) for x in leaves]
    # single sync point: every leaf copied to the host
    host_leaves = [host_array(x) for x in leaves]
    manifest = {
        "step": step,
        "treedef": tree_structure(layout),
        "n_leaves": len(host_leaves),
        "leaves": [{"shape": list(a.shape), "dtype": name}
                   for a, name in zip(host_leaves, names)],
        "extra": extra_meta or {},
    }

    def write():
        tmp = pathlib.Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
        try:
            for i, a in enumerate(host_leaves):
                np.save(tmp / f"arr_{i}.npy", a)
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        return final

    if blocking:
        return write()
    with _lock:
        fut = _executor.submit(write)
        _pending.append(fut)
    return final


def wait_for_pending():
    """Barrier for async saves (call before process exit / restore)."""
    with _lock:
        futs, _pending[:] = list(_pending), []
    for f in futs:
        f.result()


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in directory.glob("step_*")
        if (p / "manifest.json").exists()
    )
    return steps[-1] if steps else None


def load_checkpoint(
    directory: str | os.PathLike,
    template: Any,
    step: int | None = None,
    shardings: Any = None,
) -> tuple[Any, dict]:
    """Restore into ``template``'s tensors in place (each leaf cast to the
    template's dtype, on its device) and return ``(template, manifest)``.
    The leaf count and every shape are checked before anything is written.

    ``shardings`` (optional: a tree of ``NamedSharding`` or None over the
    template's reference layout) places each leaf that has one on its mesh
    instead, whatever mesh wrote the checkpoint — the elastic restore
    across device counts — and the tree returned is then the reference
    layout (:func:`restore_sharded`)."""
    directory = pathlib.Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())

    stored = [(meta["shape"], meta["dtype"], lambda i=i: np.load(path / f"arr_{i}.npy"))
              for i, meta in enumerate(manifest["leaves"])]
    if shardings is not None:
        return restore_sharded(template, stored, shardings, what="checkpoint"), manifest
    restore(template, stored, what="checkpoint")
    return template, manifest
