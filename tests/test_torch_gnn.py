"""The port's MeshGraphNet and neighbour sampler against the JAX package's,
on the CPU.

The same seeded numpy inputs and the same weights (the reference's ``init``
carried over by ``convert.gnn_params_from_numpy``, ``procs`` stacked on L)
go through both packages, on the meshgraphnet smoke model:

* the config and the param tree against the reference's;
* ``_aggregate`` for sum, mean and max, with and without an edge mask,
  empty segments included (an empty max segment is 0 in both);
* ``apply``, ``apply_batched`` and ``loss_fn`` with its gradients on the
  batches ``materialize`` draws for every GNN shape (full-batch, sampled,
  batched molecules) and with the mean and max aggregators: predictions
  and the loss within ``rtol=1e-5`` plus ``1e-6`` of the largest value,
  every gradient leaf within ``rtol=1e-4`` plus ``1e-5`` of the leaf's
  largest |value| (the scatters sum in other orders than XLA's
  ``segment_sum``);
* remat (``torch.utils.checkpoint`` a layer) against no remat: bit-equal
  under deterministic algorithms;
* weight decay by rank on the stacked ``procs``: their (L, h) biases are
  decayed and the encoders' and decoder's (h,) biases are not, as in the
  reference;
* the sampler's subgraphs bit-equal to the reference's for one seed;
* the GNN cells' three train steps against the reference's.

The reference's functions run jitted, once per config and shape.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.demo import materialize as jmaterialize
from repro.models import gnn as JG
from repro.models import sampler as JSMP
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state_from_numpy, gnn_params_from_numpy, state_to_numpy
from repro_torch.launch import train
from repro_torch.launch.demo import materialize
from repro_torch.models import gnn as G
from repro_torch.models import sampler as SMP
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import requires_grad_, tree_leaves, tree_map, tree_structure

ARCH = "meshgraphnet"
#: one shape of each train kind (ogb_products' smoke cell is full_graph_sm's:
#: the same kind, 32 nodes and 128 edges padded to 131,072)
SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
RTOL, ATOL = 1e-5, 1e-6  # atol: of the largest |value|
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # atol: of the leaf's largest |value|


@functools.cache
def _jvg(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JG.loss_fn(p, cfg, b), has_aux=True))


@functools.cache
def _jinit(cfg):
    return jax.device_get(jax.jit(JG.init, static_argnums=1)(jax.random.key(0), cfg))


def _smoke(shape_name, **replace):
    """The smoke configs at the shape's d_feat, both packages' batches of
    seed 0 (materialize's draws), and the reference's params in both."""
    jarch, arch = jget_config(ARCH), get_config(ARCH)
    _, (_, _, jbatch) = jmaterialize(jarch, jarch.shape(shape_name), smoke=True, seed=0)
    _, (_, _, batch) = materialize(arch, arch.shape(shape_name), smoke=True, seed=0,
                                   device="cpu")
    d_feat = batch["graph"]["nodes"].shape[-1]
    jcfg = dataclasses.replace(jarch.smoke_model, d_node_in=d_feat, **replace)
    cfg = dataclasses.replace(arch.smoke_model, d_node_in=d_feat, **replace)
    jp = _jinit(jcfg)
    return jcfg, jp, jax.device_get(jbatch), cfg, gnn_params_from_numpy(jp, device="cpu"), batch


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * (float(np.abs(want).max()) or 1))


def _close_tree(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL) -> float:
    worst = 0.0
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(want)]
    got, want = tree_leaves(got), [np.asarray(w, np.float32) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale, err_msg=path)
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


# ------------------------------------------------------------------ config
def test_config_and_tree_equal_the_reference():
    got, want = get_config(ARCH), jget_config(ARCH)
    assert (got.arch_id, got.family, got.source, got.notes, got.train_moment_dtype) == \
        (want.arch_id, want.family, want.source, want.notes, want.train_moment_dtype)
    assert [(s.name, s.kind, dict(s.dims)) for s in got.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in want.shapes]
    for a, b in ((got.model, want.model), (got.smoke_model, want.smoke_model)):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.pop("dtype") is torch.float32 and fb.pop("dtype") is jnp.float32
        assert fa == fb and a.params_count() == b.params_count()
        p = G.init(torch.Generator().manual_seed(0), a, device="meta")
        jp = jax.eval_shape(lambda b=b: JG.init(jax.random.key(0), b))
        assert tree_structure(p) == tree_structure(jax.tree.map(lambda _: 0, jp))
        assert [tuple(t.shape) for t in tree_leaves(p)] == \
            [tuple(x.shape) for x in jax.tree.leaves(jp)]
        real = sum(t.numel() for t in tree_leaves(p))  # within 5 %, as test_configs.py holds it
        assert abs(real - a.params_count()) / real < 0.05


# --------------------------------------------------------------- aggregate
@pytest.mark.parametrize("masked", [False, True], ids=["all_edges", "edge_mask"])
@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_aggregate_equals_the_reference(aggregator, masked):
    """40 edges into 12 nodes, nodes 9-11 receiving none (empty segments);
    with the mask a third of the edges are padding, and node 8 receives
    only padded edges."""
    rng = np.random.default_rng(6)
    msg = rng.standard_normal((40, 5)).astype(np.float32) - 2.0  # mostly negative: max != 0
    dst = rng.integers(0, 9, 40).astype(np.int32)
    mask = rng.random(40) > 1 / 3 if masked else None
    if masked:
        mask[dst == 8] = False
    args = (torch.from_numpy(msg), torch.from_numpy(dst), 12, aggregator,
            None if mask is None else torch.from_numpy(mask))
    got = G._aggregate(*args).numpy()
    want = np.asarray(JG._aggregate(jnp.asarray(msg), jnp.asarray(dst), 12, aggregator,
                                    None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[9:].any() and (not masked or not got[8].any())
    if aggregator == "max":
        assert (got[:8] < 0).any()  # a max below 0 is kept, not clamped to the buffer's 0


# ------------------------------------------------------- apply, loss, grads
_CASES = [(s, {}) for s in SHAPES] + [("minibatch_lg", {"aggregator": a}) for a in ("mean", "max")]


@pytest.mark.parametrize("shape_name,replace", _CASES,
                         ids=[s + "".join(f"-{v}" for v in r.values()) for s, r in _CASES])
def test_apply_loss_and_gradients_equal_the_reference(shape_name, replace):
    jcfg, jp, jbatch, cfg, p, batch = _smoke(shape_name, **replace)
    apply, japply = ((G.apply_batched, JG.apply_batched) if shape_name == "molecule"
                     else (G.apply, JG.apply))
    with torch.no_grad():
        pred = apply(p, cfg, batch["graph"])
    _close(pred, jax.jit(lambda q, g: japply(q, jcfg, g))(jp, jbatch["graph"]))
    (loss, aux), grads = G.value_and_grad(requires_grad_(p), cfg, batch)
    (jloss, jaux), jgrads = _jvg(jcfg)(jp, jbatch)
    _close(loss, jloss)
    _close(aux["mse"], jaux["mse"])
    _close_tree(state_to_numpy(grads), jgrads)


def test_batched_graphs_are_each_graph_alone():
    """apply_batched's disjoint union gives each molecule the answer apply
    gives it alone."""
    _, _, _, cfg, p, batch = _smoke("molecule")
    g = batch["graph"]
    with torch.no_grad():
        out = G.apply_batched(p, cfg, g)
        for b in range(g["nodes"].shape[0]):
            alone = G.apply(p, cfg, {k: v[b] for k, v in g.items()})
            torch.testing.assert_close(out[b], alone, rtol=1e-6, atol=1e-6)


def test_remat_is_bit_equal():
    """Under deterministic algorithms: with several threads the CPU's
    ``index_put_`` (the gradient of ``x[senders]``) accumulates in a
    varying order on a large graph, so two runs without remat differ too."""
    jcfg, jp, jbatch, cfg, p, batch = _smoke("minibatch_lg")
    p = requires_grad_(p)
    calls = []
    orig = torch.utils.checkpoint.checkpoint
    rcfg = dataclasses.replace(cfg, remat=True)
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        (loss, _), grads = G.value_and_grad(p, cfg, batch)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(G, "checkpoint", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
            (rloss, _), rgrads = G.value_and_grad(p, rcfg, batch)
            with torch.no_grad():  # no graph, no checkpoint
                G.apply(p, rcfg, batch["graph"])
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert len(calls) == cfg.n_layers
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(rgrads)))
    (jloss, _), _ = _jvg(dataclasses.replace(jcfg, remat=True))(jp, jbatch)
    _close(rloss, jloss)


def test_weight_decay_goes_by_rank_on_stacked_procs():
    """One AdamW step (weight decay 0.1, lr 1e-2) from zero gradients: only
    decay moves a weight. The (L, h) biases of the stacked processor layers
    move, as the reference's; the encoders' and decoder's (h,) biases do
    not."""
    jcfg, jp, _, cfg, p, _ = _smoke("full_graph_sm")
    ocfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=None)
    jocfg = JA.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=None)
    for leaf in tree_leaves(p):  # non-zero biases, so decay shows
        leaf.add_(0.5)
    jp = jax.tree.map(lambda x: x + 0.5, jp)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    updates, _ = adamw_update(tree_map(torch.zeros_like, p), adamw_init(p, ocfg), p, ocfg)
    jupdates, _ = JA.adamw_update(zeros, JA.adamw_init(jp, jocfg), jp, jocfg)
    _close_tree(state_to_numpy(updates), jupdates, rtol=1e-6, atol=1e-7)
    assert bool(updates["procs"]["edge_mlp"][0]["b"].ne(0).all())
    assert not updates["node_enc"][0]["b"].any() and not updates["decoder"][-1]["b"].any()


# ----------------------------------------------------------------- sampler
def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    rcv[rcv == 3] = 4  # node 3 has no in-neighbours
    return snd, rcv, rng.standard_normal((n, 6)).astype(np.float32)


def test_sampler_draws_the_reference_subgraphs():
    snd, rcv, feat = _graph(300, 4000, seed=7)
    ours, ref = SMP.CSRGraph(300, snd, rcv), JSMP.CSRGraph(300, snd, rcv)
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    np.testing.assert_array_equal(ours.src_sorted, ref.src_sorted)
    assert SMP.edge_budget(1024, (15, 10)) == JSMP.edge_budget(1024, (15, 10)) == \
        (169_984, 168_960)
    got = SMP.minibatch_stream(ours, feat, 16, (5, 3), seed=2)
    want = JSMP.minibatch_stream(ref, feat, 16, (5, 3), seed=2)
    n_pad, e_pad = SMP.edge_budget(16, (5, 3))
    for _ in range(3):
        a, b = next(got), next(want)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        assert a.node_ids.shape == (n_pad,) and a.senders.shape == (e_pad,)
        n, e = int(a.node_mask.sum()), int(a.edge_mask.sum())
        assert 16 <= n <= n_pad and 0 < e <= e_pad
        assert (a.node_ids[n:] == -1).all() and not a.edge_mask[e:].any()
        assert a.senders[:e].max() < n and a.receivers[:e].max() < n
        np.testing.assert_array_equal(a.node_feat[:n], feat[a.node_ids[:n]])
    sub = SMP.sample_subgraph(ours, feat, np.array([3]), (5,), np.random.default_rng(0))
    assert int(sub.node_mask.sum()) == 1 and not sub.edge_mask.any()  # no neighbours


# ------------------------------------------------------------------- cells
@pytest.mark.parametrize("shape_name", SHAPES)
def test_train_cell_three_steps_equal_the_reference(shape_name):
    """Three steps of the smoke train cell (lr 1e-3, weight decay 0.1, the
    clip) from the reference's params and moments, on the batches the
    reference's materialize(seed=step) draws: losses within rtol 1e-5,
    every weight's change within 5 % of lr of the reference's. (The
    full-batch smoke graphs sum 4,096 messages into each of 32 nodes, at
    magnitudes near 1e16: a gradient element near 0 keeps few exact bits,
    and Adam moves its weight by about lr whatever its size.)"""
    jarch, arch = jget_config(ARCH), get_config(ARCH)
    jcell, (jp, jopt, _) = jmaterialize(jarch, jarch.shape(shape_name), smoke=True, seed=0)
    cell, _ = materialize(arch, arch.shape(shape_name), smoke=True, seed=0, device="cpu")
    jp, jopt = jax.device_get((jp, jopt))
    start = jax.tree.leaves(jp)
    p = requires_grad_(gnn_params_from_numpy(jp, device="cpu"))
    opt = adamw_state_from_numpy(jopt, p)
    jstep = jax.jit(jcell.fn)
    batches = train.build_batches(arch, cell, True, torch.device("cpu"))
    for step in range(3):
        jbatch = jmaterialize(jarch, jarch.shape(shape_name), smoke=True, seed=step)[1][-1]
        batch = batches(step)
        assert list(batch) == list(jbatch) and list(batch["graph"]) == list(jbatch["graph"])
        for got, want in zip(tree_leaves(batch), jax.tree.leaves(jbatch)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jp, jopt, jm = jstep(jp, jopt, jbatch)
        p, opt, m = cell.fn(p, opt, batch)
        assert sorted(m) == sorted(jm)
        _close(m["loss"], jm["loss"])
    got = [np.asarray(g, np.float32) - s for g, s in zip(tree_leaves(state_to_numpy(p)), start)]
    want = [np.asarray(w, np.float32) - s for w, s in zip(jax.tree.leaves(jp), start)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.05 * 1e-3)
    assert int(opt.step) == int(jopt.step) == 3


def test_world_edges_example_runs(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_gnn_world_edges.py"
    spec = importlib.util.spec_from_file_location("torch_gnn_world_edges", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--n", "500"]) is True
    out = capsys.readouterr().out
    assert "mesh edges: 4000, world (collision) edges: " in out
    assert "output (500, 3), finite=True" in out
