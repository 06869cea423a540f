"""The port's recommenders against the JAX package's, on the CPU.

The same seeded numpy inputs and the same weights (the reference's ``init``
carried over by ``convert.recsys_params_from_numpy``) go through both
packages, on the smoke models of the four recsys configs (dlrm-rm2,
two-tower-retrieval, bst, wide-deep):

* the configs, the registry and the param trees against the reference's;
* ``forward`` / ``serve_scores`` within ``rtol=1e-5`` plus ``1e-6`` of the
  largest |score|; ``loss_fn`` within ``1e-5`` and every gradient leaf
  within ``rtol=1e-4`` plus ``1e-5`` of the leaf's largest |value| (the
  two packages sum the same products in other orders); the embedding
  tables' gradients are dense, as ``jnp.take``'s are;
* ``embedding_bag`` with -1 padding, sum and mean;
* ``retrieve_topk`` on the CPU (the plain ``chunk_step``) on tie-free
  candidates: scores within ``1e-5``, indices equal;
* the train, serve and retrieval cells run from ``materialize``'s batches
  against the reference's cells: three train steps from the same state;
* ``click_log_stream`` bit-equal to the reference's.

The reference's functions run jitted, once per config: eager JAX compiles
every primitive on the CPU.
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
from repro.data import click_log_stream as jclick_log_stream
from repro.launch import steps as JS
from repro.launch.demo import materialize as jmaterialize
from repro.models import recsys as JR
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state_from_numpy, recsys_params_from_numpy, state_to_numpy
from repro_torch.data import click_log_stream
from repro_torch.launch import steps as S
from repro_torch.launch.demo import materialize
from repro_torch.models import recsys as R
from repro_torch.tree import requires_grad_, tree_leaves, tree_map, tree_structure

RECSYS_ARCHS = ("dlrm-rm2", "two-tower-retrieval", "bst", "wide-deep")
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6  # atol: of the largest |score|
LOSS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # atol: of the leaf's largest |value|
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

J_INIT = jax.jit(JR.init, static_argnums=1)


@functools.cache
def _jvg(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JR.loss_fn(p, cfg, b), has_aux=True))


@functools.cache
def _jserve(cfg):
    return jax.jit(lambda p, b: JR.serve_scores(p, cfg, b))


def _models(arch_id):
    jcfg, cfg = jget_config(arch_id).smoke_model, get_config(arch_id).smoke_model
    jp = jax.device_get(J_INIT(jax.random.key(0), jcfg))
    return jcfg, jp, cfg, recsys_params_from_numpy(jp, device="cpu")


def _batch(cfg, b, seed):
    """A batch of every input the model reads, ids in range."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "dlrm":
        return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
                "sparse": np.stack([rng.integers(0, s, b) for s in cfg.table_sizes],
                                   1).astype(np.int32),
                "label": rng.integers(0, 2, b).astype(np.float32)}
    if cfg.kind == "two_tower":
        return {"user": rng.integers(0, cfg.table_sizes[0], b).astype(np.int32),
                "item": rng.integers(0, cfg.table_sizes[0], b).astype(np.int32)}
    if cfg.kind == "bst":
        mask = np.ones((b, cfg.seq_len), bool)
        mask[: b // 2, cfg.seq_len // 2:] = False  # half the rows padded
        return {"seq": rng.integers(0, cfg.table_sizes[0], (b, cfg.seq_len)).astype(np.int32),
                "target": rng.integers(0, cfg.table_sizes[0], b).astype(np.int32),
                "seq_mask": mask, "label": rng.integers(0, 2, b).astype(np.float32)}
    return {"sparse": np.stack([rng.integers(0, s, b) for s in cfg.table_sizes],
                               1).astype(np.int32),
            "label": rng.integers(0, 2, b).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_tree(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL) -> float:
    """Leaf by leaf within rtol plus atol of the leaf's largest |value|;
    returns the largest error relative to that."""
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


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_config_fields_equal_the_reference(arch_id):
    got, want = get_config(arch_id), jget_config(arch_id)
    assert (got.arch_id, got.family, got.source, got.notes) == \
        (want.arch_id, want.family, want.source, want.notes)
    assert (got.train_moment_dtype, got.train_microbatches) == \
        (want.train_moment_dtype, want.train_microbatches)
    assert [(s.name, s.kind, dict(s.dims)) for s in got.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in want.shapes]
    for a, b in ((got.model, want.model), (got.smoke_model, want.smoke_model)):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.pop("dtype") is _DTYPES[fb.pop("dtype")]
        assert fa == fb
        assert (a.total_rows, a.padded_rows, a.n_sparse, a.params_count()) == \
            (b.total_rows, b.padded_rows, b.n_sparse, b.params_count())
        assert a.feature_offsets().tolist() == np.asarray(b.feature_offsets()).tolist()


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_init_has_the_reference_tree_and_count(arch_id):
    """The reference's tree (dicts and lists, leaf shapes and dtypes), and
    ``params_count`` within 5 % of the real tree, as
    ``tests/test_configs.py::test_exact_param_counts`` holds it."""
    cfg = get_config(arch_id).smoke_model
    p = R.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda: JR.init(jax.random.key(0), jget_config(arch_id).smoke_model))
    assert tree_structure(p) == tree_structure(jax.tree.map(lambda _: 0, jp))
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(p)] == \
        [(tuple(x.shape), _DTYPES[x.dtype.type]) for x in jax.tree.leaves(jp)]
    real = sum(t.numel() for t in tree_leaves(p))
    assert abs(real - cfg.params_count()) / real < 0.05
    meta = R.init(torch.Generator(), get_config(arch_id).model, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    assert meta["embed"].shape == (get_config(arch_id).model.padded_rows,
                                   get_config(arch_id).model.embed_dim)


# ------------------------------------------------------------ forward, loss
@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_serve_scores_equal_the_reference(arch_id):
    jcfg, jp, cfg, p = _models(arch_id)
    batch = _batch(cfg, 16, seed=1)
    got = R.serve_scores(p, cfg, _t(batch)).numpy()
    want = np.asarray(_jserve(jcfg)(jp, _j(batch)))
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL * float(np.abs(want).max()))
    if cfg.kind != "two_tower":
        with torch.no_grad():
            logits = R.forward(p, cfg, _t(batch)).numpy()
        jlogits = np.asarray(jax.jit(lambda q, b: JR.forward(q, jcfg, b))(jp, _j(batch)))
        np.testing.assert_allclose(logits, jlogits, rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL * float(np.abs(jlogits).max()))


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_loss_and_gradients_equal_the_reference(arch_id):
    """Dense table gradients (every row, zeros where no id reads it), as
    the reference's; the loss and its aux within LOSS_ATOL."""
    jcfg, jp, cfg, p = _models(arch_id)
    batch = _batch(cfg, 16, seed=2)
    (loss, aux), grads = R.value_and_grad(requires_grad_(p), cfg, _t(batch))
    (jloss, jaux), jgrads = _jvg(jcfg)(jp, _j(batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert list(aux) == list(jaux)
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) <= LOSS_ATOL
    _close_tree(state_to_numpy(grads), jgrads)
    assert grads["embed"].shape == p["embed"].shape and not grads["embed"].is_sparse
    assert all(g.dtype == t.dtype for g, t in zip(tree_leaves(grads), tree_leaves(p)))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_pads_with_minus_one(mode):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, (7, 5)).astype(np.int32)
    ids[1, 2:] = -1
    ids[3, :] = -1  # an empty bag: zeros, and mean divides by 1
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode).numpy()
    want = np.asarray(JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[3].any()


def test_retrieve_topk_equals_the_reference():
    """1 user and 3 users against 4,096 candidates, k = 16, on the CPU (the
    plain chunk_step). The candidates are integers over 8, so every inner
    product is exact and the gap between two distinct ones is at least
    1/64 of the users' scale: the order has no near-ties."""
    jcfg, jp, cfg, p = _models("two-tower-retrieval")
    rng = np.random.default_rng(5)
    cand = (rng.integers(-64, 65, (4096, cfg.tower_mlp[-1])) / 8).astype(np.float32)
    for users in (np.array([3], np.int32), np.array([7, 100, 1000], np.int32)):
        got = R.retrieve_topk(p, cfg, torch.from_numpy(users), torch.from_numpy(cand), 16)
        want = jax.jit(lambda q, u, c: JR.retrieve_topk(q, jcfg, u, c, 16))(
            jp, jnp.asarray(users), jnp.asarray(cand))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                                   rtol=0, atol=1e-5)
        s = np.asarray(want.scores)
        assert (np.diff(s, axis=-1) > 1e-5).all(), "a near-tie: the order is not decided"
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_retrieval_goes_by_the_tensors_device():
    _, _, cfg, p = _models("two-tower-retrieval")
    u = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no retrieval path on meta"):
        R.mips_topk(torch.zeros(1, 8, device="meta"), torch.zeros(16, 8, device="meta"), 4)
    assert R.retrieve_topk(p, cfg, u, torch.zeros(32, 8), 4).scores.shape == (1, 4)


# --------------------------------------------------------------------- cells
def _cell_pair(arch_id, shape_name, seed=0):
    jarch, arch = jget_config(arch_id), get_config(arch_id)
    jcell, jargs = jmaterialize(jarch, jarch.shape(shape_name), smoke=True, seed=seed)
    cell, args = materialize(arch, arch.shape(shape_name), smoke=True, seed=seed, device="cpu")
    return jcell, jax.device_get(jargs), cell, args


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_cells_carry_the_reference_inputs_and_meta(arch_id):
    jarch, arch = jget_config(arch_id), get_config(arch_id)
    for shape in arch.shapes:
        for smoke in (True, False):
            jcell = JS.build_cell(jarch, jarch.shape(shape.name), smoke=smoke)
            cell = S.build_cell(arch, shape, smoke=smoke)
            assert (cell.arch_id, cell.shape_name, cell.kind, cell.meta) == \
                (jcell.arch_id, jcell.shape_name, jcell.kind, jcell.meta)
            got = [(tuple(x.shape), str(x.dtype).split(".")[-1])
                   for x in tree_leaves(cell.inputs)]
            want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jcell.inputs)]
            assert got == want
            if isinstance(jcell.inputs[-1], dict):
                assert list(cell.inputs[-1]) == list(jcell.inputs[-1])


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_train_cell_three_steps_equal_the_reference(arch_id):
    """Three steps of the smoke train cell (batch 8, lr 1e-3, weight decay
    0.1, the clip) from the reference's params and moments, on the batches
    the reference's materialize(seed=step) draws: losses within 1e-5, every
    weight's change within 2 % of lr of the reference's (Adam moves a
    weight by about lr a step whatever its gradient's size), the moments
    within 1e-3 of their leaf's largest."""
    jarch, arch = jget_config(arch_id), get_config(arch_id)
    jcell, (jp, jopt, _), cell, _ = _cell_pair(arch_id, "train_batch")
    start = jax.tree.leaves(jp)
    p = requires_grad_(recsys_params_from_numpy(jp, device="cpu"))
    opt = adamw_state_from_numpy(jopt, p)
    jstep = jax.jit(jcell.fn)
    from repro_torch.launch import train

    batches = train.build_batches(arch, cell, True, torch.device("cpu"))
    for step in range(3):
        jbatch = jmaterialize(jarch, jarch.shape("train_batch"), smoke=True, seed=step)[1][-1]
        batch = batches(step)
        assert list(batch) == list(jbatch)
        for k in jbatch:
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]))
        jp, jopt, jm = jstep(jp, jopt, jbatch)
        p, opt, m = cell.fn(p, opt, batch)
        assert sorted(m) == sorted(jm)  # jit returns its dict by sorted key
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    got = [np.asarray(g, np.float32) - s for g, s in zip(tree_leaves(state_to_numpy(p)), start)]
    want = [np.asarray(w, np.float32) - s for w, s in zip(jax.tree.leaves(jp), start)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.02 * 1e-3)
    assert int(opt.step) == int(jopt.step) == 3
    _close_tree(state_to_numpy(opt.m), jopt.m, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_serve_and_retrieval_cells_equal_the_reference(arch_id):
    """materialize's serve and retrieval inputs are the reference's draws;
    on the reference's params the cells' outputs are the reference's
    (retrieval: scores within 1e-5, indices equal where the reference's
    scores around them are more than 1e-5 apart)."""
    jcell, jargs, cell, args = _cell_pair(arch_id, "serve_p99", seed=3)
    for k in jargs[1]:
        np.testing.assert_array_equal(args[1][k].numpy(), np.asarray(jargs[1][k]))
    p = recsys_params_from_numpy(jargs[0], device="cpu")
    got = cell.fn(p, args[1]).numpy()
    want = np.asarray(jax.jit(jcell.fn)(*jargs))
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL * float(np.abs(want).max()))

    jcell, jargs, cell, args = _cell_pair(arch_id, "retrieval_cand", seed=4)
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(jargs[2]))
    p = recsys_params_from_numpy(jargs[0], device="cpu")
    got = cell.fn(p, args[1], args[2])
    want = jax.jit(jcell.fn)(*jargs)
    s = np.asarray(want.scores)
    np.testing.assert_allclose(got.scores.numpy(), s, rtol=0, atol=1e-5)
    gap = np.diff(s, axis=-1) > 1e-5
    decided = np.concatenate([gap[:, :1], gap[:, 1:] & gap[:, :-1], gap[:, -1:]], -1)
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(got.indices.numpy()[decided], np.asarray(want.indices)[decided])


# ---------------------------------------------------------------------- data
def test_click_log_stream_is_the_reference():
    batch = next(click_log_stream((10, 20, 30), 5, 64, seed=0))
    assert batch["sparse"].shape == (64, 3)
    for i, size in enumerate((10, 20, 30)):
        assert batch["sparse"][:, i].max() < size
    assert set(np.unique(batch["label"])) <= {0.0, 1.0}
    got = click_log_stream((100, 50, 200, 30), 13, 32, seed=7)
    want = jclick_log_stream((100, 50, 200, 30), 13, 32, seed=7)
    for _ in range(3):
        x, y = next(got), next(want)
        assert list(x) == list(y)
        for k in y:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_params_from_numpy_keeps_the_tree_and_bits():
    _, jp, _, p = _models("wide-deep")
    assert tree_structure(p) == tree_structure(jax.tree.map(lambda _: 0, jp))
    for g, w in zip(tree_leaves(state_to_numpy(p)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(g, np.asarray(w))
    back = tree_map(lambda t: t.numpy(), p)
    assert back["wide_bias"].shape == () and back["wide"].shape[-1] == 1


# ------------------------------------------------------------------ examples
def _example(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dense_retrieval_example_finds_the_source_passages(capsys):
    recall = _example("torch_dense_retrieval").main(
        ["--device", "cpu", "--passages", "4000", "--queries", "200"])
    out = capsys.readouterr().out
    assert "recall@10 of source passage: " in out and recall >= 0.95
    # which plans serve depends on the measured service times (the
    # scheduler's clock): a burst of 64 always queues into an FQ-SD batch
    assert "plan=fqsd" in out and "executors=fdsq-cuda" in out


def test_image_retrieval_example_streams_the_resident_answer(capsys):
    res = _example("torch_image_retrieval_streaming").main(
        ["--device", "cpu", "--n", "20000", "--d", "64"])
    out = capsys.readouterr().out
    assert "streamed result == resident result (exact)" in out
    assert res.plan.executor == "fqsd-mmap-streamed" and res.stats["transfers"] == 3
