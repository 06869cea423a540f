"""The port's sharding rules, placement, elasticity and dry run, held to
the reference's.

The reference's mesh-dependent answers come from one subprocess per
module with eight host devices (``--xla_force_host_platform_device_count=8``):
this file, run as a script, writes them to a ``.json``. The port runs in
this process on meshes of logical CPU devices (``["cpu"] * n``). Specs
compare entry by entry; placed blocks bit for bit, at every mesh position.

* ``resolve`` / ``spec`` / ``sanitize_spec`` / ``axis_rules`` on a list of
  logical tuples, under no mesh, (data=2, model=4) and (pod=1, data=2,
  model=4).
* every cell's specs, 45 smoke and 45 full-size, built under (2, 4): the
  ``in_specs`` and ``out_specs`` as the cell carries them, and the
  ``in_specs`` sanitized against the inputs' shapes.
* ``place`` and ``DataPipeline(mesh=, specs=)``: each position's block,
  against the reference's ``addressable_shards``.
* ``best_mesh_shape`` for 1-16 devices; a 4 -> 2 -> 4 ``reshard_tree`` and
  ``load_checkpoint(shardings=)`` round trip, bitwise.
* ``python -m repro_torch.launch.dryrun --arch knn-search --shape
  msmarco_fdsq --mesh single``: its record's per-device bytes, reckoned by
  hand here.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np

LOGICAL = (("batch", "seq", "embed"), ("heads",), ("fsdp", "heads"), ("edges", None),
           ("rows", None), ("vocab", "batch_nopod", "nodes"), ("kv_heads", "expert", "ffn"),
           (None,), ())
RULES = {"batch": ("data", "model"), "heads": None, "rows": ("pod", "model"), "vocab": "data"}
SANITIZE = (((12, 8), ("data", "model")), ((6, 4), (("data", "model"), None)),
            ((36, 64), ("model",)), ((122753, 2304), ("model", "data")),
            ((8, 3, 5), (None, "data")), ((1,), ("model",)))
SIZES = {"data": 2, "model": 4}
PLACE_SHAPE = (8, 16)
PLACE_SPECS = (("data", "model"), (("data", "model"),), (None, "model"), ("model", "data"),
               (), (("model", "data"), None), (None, ("data", "model")))
BATCH = {"tokens": (8, 6), "x": (8, 3)}


def _entries(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def place_array():
    return np.arange(math.prod(PLACE_SHAPE), dtype=np.float32).reshape(PLACE_SHAPE)


def batch_arrays():
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, 99, BATCH["tokens"]).astype(np.int32),
            "x": rng.standard_normal(BATCH["x"]).astype(np.float32)}


# ------------------------------------------------------ the reference side
def _reference(out: str) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.configs import ALL_ARCHS, get_config
    from repro.data import DataPipeline
    from repro.launch.steps import build_cell
    from repro.runtime import sharding as S

    def mesh_of(shape, names=("data", "model")):
        return compat.make_mesh(shape, names, devices=jax.devices()[:math.prod(shape)])

    res = {"resolve": {}, "sanitize": [], "cells": {}, "place": {}, "pipeline": {}}
    meshes = {"none": None, "2x4": mesh_of((2, 4)),
              "pod1x2x4": mesh_of((1, 2, 4), ("pod", "data", "model"))}
    for tag, mesh in meshes.items():
        for rules_tag, rules in (("default", None), ("custom", RULES)):
            ctx = compat.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
            with ctx, (S.axis_rules(rules) if rules else contextlib.nullcontext()):
                res["resolve"][f"{tag}|{rules_tag}"] = [
                    [_entries(S.resolve(lg)), _entries(S.spec(*lg))] for lg in LOGICAL]
    for shape, spec in SANITIZE:
        res["sanitize"].append(_entries(S.sanitize_spec(shape, P(*spec), SIZES)))

    mesh = meshes["2x4"]
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    with compat.use_mesh(mesh):
        for smoke in (True, False):
            for arch_id in ALL_ARCHS:
                arch = get_config(arch_id)
                for shape in arch.shapes:
                    cell = build_cell(arch, shape, smoke=smoke)
                    san = jax.tree.map(
                        lambda s, sp: S.sanitize_spec(s.shape, sp, SIZES), cell.inputs,
                        cell.in_specs, is_leaf=lambda x: x is None)
                    res["cells"][f"{arch_id}|{shape.name}|{smoke}"] = [
                        [_entries(s) for s in jax.tree.leaves(t, is_leaf=is_spec)]
                        for t in (cell.in_specs, cell.out_specs, san)]
        x = place_array()
        for spec in PLACE_SPECS:
            arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
            flat = list(mesh.devices.flat)
            blocks = {flat.index(s.device): np.asarray(s.data).tolist()
                      for s in arr.addressable_shards}
            res["place"][repr(spec)] = [blocks[p] for p in range(len(flat))]
        specs = {"tokens": P("data", None), "x": P()}
        (batch,) = list(DataPipeline([batch_arrays()], depth=2, mesh=mesh, specs=specs))
        flat = list(mesh.devices.flat)
        for key, arr in batch.items():
            blocks = {flat.index(s.device): np.asarray(s.data).tolist()
                      for s in arr.addressable_shards}
            res["pipeline"][key] = [blocks[p] for p in range(len(flat))]
    pathlib.Path(out).write_text(json.dumps(res))


if __name__ == "__main__":
    _reference(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------- the port side
import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import load_checkpoint as jload_checkpoint  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.elastic import best_mesh_shape as jbest_mesh_shape  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core.mesh import make_mesh, use_mesh  # noqa: E402
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import sharding as S  # noqa: E402
from repro_torch.runtime.elastic import best_mesh_shape, remesh, reshard_tree  # noqa: E402
from repro_torch.runtime.sharding import NamedSharding, P, Sharded, place  # noqa: E402
from repro_torch.tree import Stack, reference_layout, tree_leaves, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's answers, computed once per module in a subprocess."""
    out = tmp_path_factory.mktemp("sharding_ref") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return json.loads(out.read_text())


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=["cpu"] * math.prod(shape))


def _leaf_specs(tree) -> list:
    return [_entries(s) for s in tree_leaves(tree)]


@pytest.mark.parametrize("tag", ["none", "2x4", "pod1x2x4"])
def test_resolve_spec_and_axis_rules(ref, tag):
    mesh = {"none": None, "2x4": _mesh((2, 4)),
            "pod1x2x4": _mesh((1, 2, 4), ("pod", "data", "model"))}[tag]
    for rules_tag, rules in (("default", None), ("custom", RULES)):
        with use_mesh(mesh), (S.axis_rules(rules) if rules else contextlib.nullcontext()):
            got = [[_entries(S.resolve(lg)), _entries(S.spec(*lg))] for lg in LOGICAL]
        assert got == ref["resolve"][f"{tag}|{rules_tag}"], rules_tag
    assert S.current_rules() is S.DEFAULT_RULES


def test_sanitize_spec(ref):
    got = [_entries(S.sanitize_spec(shape, P(*spec), SIZES)) for shape, spec in SANITIZE]
    assert got == ref["sanitize"]
    assert P(("data",), None) == P("data", None) != P("data")


def _sanitized(inputs, specs):
    def one(x, sp):
        return S.sanitize_spec(tuple(x.shape), sp, SIZES) if hasattr(x, "shape") else sp
    return tree_map(one, reference_layout(inputs), specs)


def test_every_cells_specs_under_a_2x4_mesh(ref):
    mesh = _mesh((2, 4))
    got = {}
    with use_mesh(mesh):
        for smoke in (True, False):
            for arch_id in ALL_ARCHS:
                arch = get_config(arch_id)
                for shape in arch.shapes:
                    cell = build_cell(arch, shape, smoke=smoke)
                    got[f"{arch_id}|{shape.name}|{smoke}"] = [
                        _leaf_specs(cell.in_specs), _leaf_specs(cell.out_specs),
                        _leaf_specs(_sanitized(cell.inputs, cell.in_specs))]
    assert len(got) == 90 and set(got) == set(ref["cells"])
    bad = [key for key in got if got[key] != ref["cells"][key]]
    assert not bad, bad


@pytest.mark.parametrize("spec", PLACE_SPECS, ids=repr)
def test_place_blocks_are_the_references_shards(ref, spec):
    mesh = _mesh((2, 4))
    x = torch.from_numpy(place_array())
    placed = place(x, P(*spec), mesh)
    assert [b.tolist() for b in placed.blocks] == ref["place"][repr(spec)]
    assert torch.equal(placed.full(), x)
    assert all(b.device.type == "cpu" for b in placed.blocks)


def test_place_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        place(torch.zeros(6, 5), P(None, "model"), _mesh((2, 4)))


def test_data_pipeline_places_each_leaf_by_its_spec(ref):
    mesh = _mesh((2, 4))
    (batch,) = list(DataPipeline([batch_arrays()], depth=2, mesh=mesh,
                                 specs={"tokens": P("data", None), "x": None}))
    for key, arr in batch.items():
        assert isinstance(arr, Sharded)
        assert [b.tolist() for b in arr.blocks] == ref["pipeline"][key], key
    (whole,) = list(DataPipeline([batch_arrays()], mesh=mesh))
    assert all(len(set(map(str, (b.tolist() for b in a.blocks)))) == 1 for a in whole.values())


def test_best_mesh_shape_matches_the_reference():
    for n in range(1, 17):
        for prefer in (16, 4):
            assert best_mesh_shape(n, prefer) == jbest_mesh_shape(n, prefer)
    mesh = remesh(["cpu"] * 12, prefer_model=8)
    assert mesh.shape == {"data": 2, "model": 6}


def _lm_state():
    jcfg, cfg = jget_config("qwen2.5-14b").smoke_model, get_config("qwen2.5-14b").smoke_model
    jp = jax.jit(JT.init, static_argnums=1)(jax.random.key(0), jcfg)
    from repro_torch.convert import lm_params_from_numpy

    return cfg, jp, lm_params_from_numpy(jp, cfg, device="cpu")


def _bits_equal(a, b) -> bool:
    a = torch.stack(a.parts) if isinstance(a, Stack) else a
    b = torch.stack(b.parts) if isinstance(b, Stack) else b
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _whole(leaf):
    if isinstance(leaf, Stack):
        return Stack(_whole(p) for p in leaf.parts)
    return leaf.full() if isinstance(leaf, Sharded) else leaf


def test_reshard_and_checkpoint_round_trip_4_2_4(tmp_path):
    cfg, jp, params = _lm_state()
    layout = reference_layout(params)
    mesh4 = remesh(["cpu"] * 4, prefer_model=2)
    with use_mesh(mesh4):
        specs = T.param_specs(cfg, training=True)
    placed4 = reshard_tree(layout, specs, mesh4)
    wq = placed4["layers"]["attn"]["wq"].parts[0]
    assert wq.spec == P("data", "model") and wq.blocks[1].shape == (wq.shape[0] // 2,
                                                                      wq.shape[1] // 2)
    mesh2 = remesh(["cpu"] * 2)
    assert mesh2.shape == {"data": 1, "model": 2}
    placed2 = reshard_tree(placed4, specs, mesh2)
    back4 = reshard_tree(placed2, specs, mesh4)
    for a, b in zip(tree_leaves(layout), tree_leaves(back4)):
        assert _bits_equal(a, _whole(b))

    save_checkpoint(tmp_path / "a", 1, placed4)
    shard2 = tree_map(lambda x, sp: NamedSharding(mesh2, S.sanitize_spec(
        tuple(x.shape), sp, dict(mesh2.shape))), layout, specs)
    got2, manifest = load_checkpoint(tmp_path / "a", placed4, shardings=shard2)
    assert manifest["step"] == 1
    assert got2["head"].mesh == mesh2 and len(got2["head"].blocks) == 2
    save_checkpoint(tmp_path / "b", 2, got2)
    manager = CheckpointManager(tmp_path / "b")
    shard4 = tree_map(lambda x, sp: NamedSharding(mesh4, S.sanitize_spec(
        tuple(x.shape), sp, dict(mesh4.shape))), layout, specs)
    got4, step = manager.restore_latest(got2, shardings=shard4)
    assert step == 2
    for a, b in zip(tree_leaves(layout), tree_leaves(got4)):
        assert _bits_equal(a, _whole(b))
    # the files are full arrays: the reference opens them
    jtree, _ = jload_checkpoint(tmp_path / "b", jp)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jp)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_a_leaf_without_a_sharding_is_restored_in_place(tmp_path):
    cfg, _, params = _lm_state()
    save_checkpoint(tmp_path, 3, params)
    template = T.init(torch.Generator().manual_seed(5), cfg, device="cpu")
    layout = reference_layout(template)
    mesh = _mesh((1, 2))
    shardings = tree_map(lambda _: None, layout)
    shardings["head"] = NamedSharding(mesh, P(None, "model"))
    got, _ = load_checkpoint(tmp_path, template, shardings=shardings)
    assert got["embed"] is template.embed and torch.equal(template.embed, params.embed)
    assert isinstance(got["head"], Sharded) and torch.equal(got["head"].full(), params.head)
    assert not torch.equal(template.head, params.head)  # placed, not written in place


def test_dryrun_msmarco_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    assert dryrun.main(["--arch", "knn-search", "--shape", "msmarco_fdsq",
                        "--mesh", "single"]) == 0
    rec = json.loads((tmp_path / "knn-search__msmarco_fdsq__single.json").read_text())
    # by hand: 256 positions; rows padded to 128 x 256, d to 128; the
    # dataset and norms split over (data, model), the query and the
    # (m, k) answer (f32 scores, int32 ids) replicated
    shape = jget_config("knn-search").shape("msmarco_fdsq")
    n, d, m, k = shape["n"], shape["d"], shape["m"], shape["k"]
    n_pad, d_pad = -(-n // 32768) * 32768, -(-d // 128) * 128
    args = m * d_pad * 4 + n_pad * d_pad * 4 // 256 + n_pad * 4 // 256
    mem = rec["memory_analysis"]
    assert (mem["argument_bytes"], mem["output_bytes"], mem["alias_bytes"]) == (
        args, m * k * 8, 0)
    assert mem["per_device_bytes"] == args + m * k * 8 and mem["fits_h100_hbm"]
    assert mem["temp_bytes"] is None and "no XLA compile" in mem["note"]
    assert rec["cost_analysis"] is None and "no XLA compile" in rec["cost_analysis_note"]
    assert rec["roofline"]["collective_s"] is None and rec["chips"] == 256


def test_dryrun_counts_donated_state_once(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    rec = dryrun.run_cell("dlrm-rm2", "train_batch", "single")
    mem = rec["memory_analysis"]
    assert mem["alias_bytes"] > 0
    assert mem["per_device_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
        - mem["alias_bytes"]
    assert mem["output_bytes"] - mem["alias_bytes"] == 2 * 4  # loss and bce
