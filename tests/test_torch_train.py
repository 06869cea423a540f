"""The port's LM training path against the JAX package's, on the CPU.

The same seeded numpy inputs and the same weights (the reference's ``init``
carried over by ``convert``) go through both packages:

* ``loss_fn``'s value and gradients against ``jax.value_and_grad`` on the
  smoke models of all five LM configs in f32 (dense, GQA with QKV biases,
  d_head 12, MoE top-2 of 8 and top-2 of 4 with capacity drops), and
  through the blockwise-flash attention. Loss within ``1e-5``; every
  gradient leaf within ``rtol=1e-4`` plus ``1e-5`` of the leaf's largest
  value (the two packages sum the same products in other orders, and the
  backward sums over every token; measured: losses within 9.5e-07,
  gradients within 2.0e-06 of their leaf's largest value, qwen3-moe's the
  worst). The MoE configs route by a sort, so the batch is
  checked to have no token whose k-th and (k+1)-th router probabilities
  are within 1e-6 (a tie the two packages could break apart);
* remat (``torch.utils.checkpoint`` a layer, and a KV step in the flash
  path) against no remat: bit-equal in the port, and within the same
  tolerance of the reference's ``jax.checkpoint``;
* ``launch.steps``' train cell, three steps from the same params, moments
  and batches, against the reference's cell; microbatch accumulation
  (``train_microbatches=2``) against the reference's ``lax.scan``;
* the reference's ``TestFaultTolerance`` on the port, a failure before the
  first checkpoint, the data pipeline, the train CLI and the example.

The reference's functions run jitted, once per config: eager JAX compiles
every primitive on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_config as jget_config
from repro.data import DataPipeline as JDataPipeline
from repro.data import token_stream as jtoken_stream
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as B
from repro_torch.configs import get_config
from repro_torch.convert import (
    adamw_state_from_numpy, lm_params_from_numpy, state_to_numpy,
)
from repro_torch.data import DataPipeline, token_stream
from repro_torch.launch import steps as S
from repro_torch.launch.demo import materialize
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, apply_updates
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault import FailureInjector, StragglerDetector, supervised_train
from repro_torch.tree import reference_layout, tree_leaves

LM_ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-30b-a3b", "qwen2.5-14b", "starcoder2-7b", "minicpm-2b")
LOSS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # atol: of the leaf's largest |value|
ROUTE_GAP = 1e-6


@functools.cache
def _jvg(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b), has_aux=True))


J_INIT = jax.jit(JT.init, static_argnums=1)


def _models(arch, **replace):
    jcfg = dataclasses.replace(jget_config(arch).smoke_model, **replace)
    cfg = dataclasses.replace(get_config(arch).smoke_model, **replace)
    jp = jax.device_get(J_INIT(jax.random.key(0), jcfg))
    return jcfg, jp, cfg, lm_params_from_numpy(jp, cfg, device="cpu").requires_grad_(True)


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close_tree(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL) -> float:
    """Leaf by leaf within rtol plus atol of the leaf's largest |value|;
    returns the largest error relative to that."""
    worst = 0.0
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(want)]
    got, want = tree_leaves(got), [np.asarray(w, np.float32) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        g = np.asarray(g, np.float32)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale, err_msg=path)
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


@pytest.fixture
def route_gaps(monkeypatch):
    """Every _moe_dense call's smallest gap between a token's k-th and
    (k+1)-th router probability."""
    gaps, orig = [], L._moe_dense

    def traced(params, x, *, n_experts, top_k, capacity_factor):
        with torch.no_grad():
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ params["router"], -1)
            top = torch.sort(probs, -1, descending=True).values
            gaps.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return orig(params, x, n_experts=n_experts, top_k=top_k,
                    capacity_factor=capacity_factor)

    monkeypatch.setattr(L, "_moe_dense", traced)
    return gaps


# -------------------------------------------------------------- gradients
_GRAD_CASES = [(a, {}) for a in LM_ARCHS] + [
    ("minicpm-2b", dict(flash_threshold=8, q_block=8, kv_block=8)),  # blockwise flash
]


@pytest.mark.parametrize("arch,replace", _GRAD_CASES,
                         ids=[a + ("-flash" if r else "") for a, r in _GRAD_CASES])
def test_loss_and_gradients_equal_the_reference(arch, replace, route_gaps):
    jcfg, jp, cfg, p = _models(arch, **replace)
    tok = _tokens(1, cfg.vocab, 2, 17)
    (loss, aux), grads = T.value_and_grad(p, cfg, {"tokens": torch.from_numpy(tok)})
    (jloss, jaux), jgrads = _jvg(jcfg)(jp, {"tokens": jnp.asarray(tok)})
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert abs(float(aux["nll"]) - float(jaux["nll"])) <= LOSS_ATOL
    _close_tree(state_to_numpy(grads), jgrads)
    assert all(g.dtype == t.dtype for g, t in zip(grads.values(), p.parameters()))
    if cfg.is_moe:
        assert route_gaps and min(route_gaps) > ROUTE_GAP, min(route_gaps)


@pytest.mark.parametrize("arch,replace", [("qwen3-moe-30b-a3b", {}),
                                          ("minicpm-2b", dict(flash_threshold=8, q_block=8,
                                                              kv_block=8))])
def test_remat_is_bit_equal_and_the_reference_remat(arch, replace):
    jcfg, jp, cfg, p = _models(arch, **replace)
    tok = {"tokens": torch.from_numpy(_tokens(2, cfg.vocab, 2, 17))}
    (loss, _), grads = T.value_and_grad(p, cfg, tok)
    calls = []
    orig = torch.utils.checkpoint.checkpoint
    rcfg = dataclasses.replace(cfg, remat=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "checkpoint", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
        (rloss, _), rgrads = T.value_and_grad(p, rcfg, tok)
    assert len(calls) == cfg.n_layers
    assert torch.equal(loss, rloss)
    assert all(torch.equal(grads[n], rgrads[n]) for n in grads)
    (jloss, _), jgrads = _jvg(dataclasses.replace(jcfg, remat=True))(
        jp, {"tokens": jnp.asarray(tok["tokens"].numpy())})
    assert abs(float(rloss) - float(jloss)) <= LOSS_ATOL
    _close_tree(state_to_numpy(rgrads), jgrads)
    with torch.no_grad():  # no graph, no checkpoint: serving's path
        assert torch.equal(T.apply(p, rcfg, tok["tokens"][:, :-1])[0],
                           T.apply(p, cfg, tok["tokens"][:, :-1])[0])


def test_serving_builds_no_graph_on_trainable_weights():
    _, _, cfg, p = _models("minicpm-2b")
    tok = torch.from_numpy(_tokens(3, cfg.vocab, 2, 6))
    logits, cache = T.prefill(p, cfg, tok, max_len=8)
    step, cache = T.decode_step(p, cfg, cache, tok[:, :1])
    assert not logits.requires_grad and not step.requires_grad
    assert not cache["k"].requires_grad


# ------------------------------------------------------------- train cells
def _ref_cell_batches(jcell, vocab, steps):
    out = []
    for step in range(steps):
        rng = np.random.default_rng(step)
        out.append({k: rng.integers(0, vocab, v.shape).astype(np.int32)
                    for k, v in jcell.inputs[2].items()})
    return out


def _run_cells(jarch, arch, shape, jshape, smoke, steps, seed=0):
    """steps of the reference's cell and the port's from the same params,
    moments and batches; returns the losses and final states of both."""
    jcell = JS.build_lm_cell(jarch, jshape, smoke=smoke)
    cell = S.build_lm_cell(arch, shape, smoke=smoke)
    jcfg = jarch.smoke_model if smoke else jarch.model
    cfg = arch.smoke_model if smoke else arch.model
    jp = jax.device_get(J_INIT(jax.random.key(seed), jcfg))
    jopt = JA.adamw_init(jp, JA.AdamWConfig(moment_dtype=jarch.train_moment_dtype))
    p = lm_params_from_numpy(jp, cfg, device="cpu").requires_grad_(True)
    opt = adamw_state_from_numpy(jax.device_get(jopt), p)
    jstep = jax.jit(jcell.fn)
    losses, jlosses = [], []
    for batch in _ref_cell_batches(jcell, cfg.vocab, steps):
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        p, opt, m = cell.fn(p, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    return (losses, (p, opt)), (jlosses, (jp, jopt))


def _moves(state, jstate, jstart):
    """Each leaf's change over the run, the port's against the reference's."""
    start = jax.tree.leaves(jstart)
    got = [np.asarray(g, np.float32) - np.asarray(s, np.float32)
           for g, s in zip(tree_leaves(state_to_numpy(state)), start)]
    want = [np.asarray(w, np.float32) - np.asarray(s, np.float32)
            for w, s in zip(jax.tree.leaves(jstate), start)]
    return got, want


@pytest.mark.parametrize("arch_id", ["qwen2.5-14b", "qwen3-moe-30b-a3b"])
def test_train_cell_three_steps_equal_the_reference(arch_id):
    """The smoke train cell (batch 2 x 16, lr 1e-4, weight decay 0.1, the
    clip; qwen3-moe's bf16 moments). Losses within 1e-5; every weight's
    change over the three steps within 2 % of lr of the reference's (Adam
    moves a weight by about lr a step whatever its gradient's size)."""
    jarch, arch = jget_config(arch_id), get_config(arch_id)
    shape, jshape = arch.shape("train_4k"), jarch.shape("train_4k")
    (losses, state), (jlosses, jstate) = _run_cells(jarch, arch, shape, jshape, True, 3)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_ATOL)
    jstart = jax.device_get(J_INIT(jax.random.key(0), jarch.smoke_model))
    got, want = _moves(state[0], jstate[0], jstart)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.02 * 1e-4)
    assert int(state[1].step) == int(jstate[1].step) == 3
    _close_tree(state_to_numpy(state[1].m, bf16=jnp.bfloat16), jstate[1].m, rtol=1e-3, atol=1e-3)


def test_microbatch_accumulation_equals_the_reference_scan():
    """train_microbatches=2 over a 4 x 16 train shape with smoke=False (the
    reference forces one microbatch under smoke): the grads accumulate in
    the param dtype and are divided by 2, in both packages."""
    jcfg, cfg = jget_config("minicpm-2b").smoke_model, get_config("minicpm-2b").smoke_model
    dims = {"seq_len": 16, "global_batch": 4}
    jarch = JB.ArchConfig("mb", "lm", jcfg, jcfg, (JB.ShapeSpec("train_mb", "train", dims),),
                          train_microbatches=2)
    arch = B.ArchConfig("mb", "lm", cfg, cfg, (B.ShapeSpec("train_mb", "train", dims),),
                        train_microbatches=2)
    (losses, state), (jlosses, jstate) = _run_cells(
        jarch, arch, arch.shapes[0], jarch.shapes[0], False, 2)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_ATOL)
    got, want = _moves(state[0], jstate[0], jax.device_get(J_INIT(jax.random.key(0), jcfg)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.02 * 1e-4)


def test_cells_carry_the_reference_inputs_and_meta():
    for arch_id, name in (("minicpm-2b", "train_4k"), ("qwen2.5-14b", "prefill_32k"),
                          ("qwen3-moe-30b-a3b", "decode_32k"), ("knn-search", "gist_fqsd"),
                          ("knn-search", "msmarco_fdsq")):
        for smoke in (True, False):
            jarch, arch = jget_config(arch_id), get_config(arch_id)
            jcell = JS.build_cell(jarch, jarch.shape(name), smoke=smoke)
            cell = S.build_cell(arch, arch.shape(name), smoke=smoke)
            assert (cell.arch_id, cell.shape_name, cell.kind, cell.meta) == \
                (jcell.arch_id, jcell.shape_name, jcell.kind, jcell.meta)
            want = [tuple(x.shape) for x in jax.tree.leaves(jcell.inputs[-1])]
            assert [tuple(x.shape) for x in tree_leaves(cell.inputs[-1])] == want
            if arch.family == "lm":
                assert [tuple(x.shape) for x in tree_leaves(reference_layout(cell.inputs[0]))] \
                    == [tuple(x.shape) for x in jax.tree.leaves(jcell.inputs[0])]
                assert all(t.device.type == "meta" for t in cell.inputs[0].parameters())


def test_materialize_draws_the_reference_batch():
    from repro.launch.demo import materialize as jmaterialize

    for arch_id, name in (("minicpm-2b", "train_4k"), ("starcoder2-7b", "prefill_32k"),
                          ("qwen2.5-14b", "decode_32k"), ("knn-search", "gist_fqsd")):
        jarch, arch = jget_config(arch_id), get_config(arch_id)
        _, jargs = jmaterialize(jarch, jarch.shape(name), smoke=True, seed=3)
        _, args = materialize(arch, arch.shape(name), smoke=True, seed=3, device="cpu")
        got, want = args[-1], jargs[-1]
        if isinstance(want, dict):
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        elif arch.family == "knn":
            np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
            np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if name == "train_4k":
            assert all(t.requires_grad for t in args[0].parameters())
        if name == "decode_32k":
            assert args[1]["len"] == int(jargs[1]["len"])


def test_gnn_and_recsys_cells_wait_for_their_models():
    """The models are ported: build_cell builds every GNN and recsys shape
    (smoke=True), with the reference cell's kind and meta, and an unknown
    family still raises."""
    for arch_id in ("meshgraphnet", "dlrm-rm2", "two-tower-retrieval", "bst", "wide-deep"):
        arch, jarch = get_config(arch_id), jget_config(arch_id)
        for shape in arch.shapes:
            cell = S.build_cell(arch, shape, smoke=True)
            jcell = JS.build_cell(jarch, jarch.shape(shape.name), smoke=True)
            assert (cell.kind, cell.meta) == (jcell.kind, jcell.meta)
            assert all(t.device.type == "meta" for t in tree_leaves(cell.inputs))
    arch = dataclasses.replace(get_config("minicpm-2b"), family="vision")
    with pytest.raises(ValueError, match="vision"):
        S.build_cell(arch, arch.shape("train_4k"))


# ------------------------------------------------------- fault tolerance
class TestFaultTolerance:
    """The reference's suite on the port. The port's step updates its state
    in place, so each run starts from a state of its own."""

    def _setup(self, tmp_path):
        cfg = AdamWConfig(lr=0.1)

        def step_fn(state, batch):
            p, opt = state
            grads = {"w": p["w"] - batch}  # pull towards batch
            u, opt = adamw_update(grads, opt, p, cfg)
            p = apply_updates(p, u)
            loss = torch.mean((p["w"] - batch) ** 2)
            return (p, opt), {"loss": loss}

        def state0():
            p0 = {"w": torch.zeros(4)}
            return p0, adamw_init(p0, cfg)

        batches = lambda step: torch.tensor(1.0)  # noqa: E731
        return step_fn, state0, batches

    @pytest.mark.parametrize("fail_at", [(5, 10), (1,), (0, 2, 7)])
    def test_recovery_is_deterministic(self, tmp_path, fail_at):
        """(1,) and (0, 2, 7) fail before the first checkpoint (step 3)."""
        step_fn, state0, batches = self._setup(tmp_path)
        clean, rep1 = supervised_train(
            step_fn, state0(), batches, 12,
            CheckpointManager(tmp_path / "a", interval=3, async_save=False),
        )
        assert rep1.restarts == 0
        crashy, rep2 = supervised_train(
            step_fn, state0(), batches, 12,
            CheckpointManager(tmp_path / "b", interval=3, async_save=True),
            injector=FailureInjector(fail_at=fail_at),
        )
        assert rep2.restarts == len(fail_at) and rep2.steps_done == 12
        assert torch.equal(clean[0]["w"], crashy[0]["w"])
        assert torch.equal(clean[1].m["w"], crashy[1].m["w"])
        assert int(crashy[1].step) == 12

    def test_a_failure_mid_step_before_the_first_save(self, tmp_path):
        """A step that dies after it has updated the state in place: the
        replay starts from the initial state, not the half-updated one."""
        step_fn, state0, batches = self._setup(tmp_path)
        clean, _ = supervised_train(step_fn, state0(), batches, 6,
                                    CheckpointManager(tmp_path / "a", interval=4))
        died = []

        def dies_once(state, batch):
            state, metrics = step_fn(state, batch)
            if len(died) == 0 and int(state[1].step) == 2:
                died.append(1)
                raise RuntimeError("lost after the update")
            return state, metrics

        crashy, rep = supervised_train(dies_once, state0(), batches, 6,
                                       CheckpointManager(tmp_path / "b", interval=4))
        assert rep.restarts == 1
        assert torch.equal(clean[0]["w"], crashy[0]["w"])

    def test_restart_budget_exhausted(self, tmp_path):
        step_fn, state0, batches = self._setup(tmp_path)

        def always_fail(state, batch):
            raise RuntimeError("dead host")

        with pytest.raises(RuntimeError):
            supervised_train(
                always_fail, state0(), batches, 4,
                CheckpointManager(tmp_path / "c", interval=1, async_save=False),
                max_restarts=2,
            )

    def test_straggler_detection(self):
        det = StragglerDetector(warmup=2, straggler_factor=2.0)
        for step, t in enumerate([1.0, 1.0, 1.0, 1.05, 5.0, 1.0]):
            det.observe(step, t)
        assert len(det.flagged) == 1 and det.flagged[0]["step"] == 4
        # EWMA not polluted by the outlier
        assert det.mean < 1.2


# ------------------------------------------------------------------- data
def test_token_stream_is_the_reference():
    a = next(token_stream(100, 4, 8, seed=3))
    b = next(token_stream(100, 4, 8, seed=3))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < 100
    got, want = token_stream(50, 3, 5, seed=7), jtoken_stream(50, 3, 5, seed=7)
    for _ in range(3):
        x, y = next(got), next(want)
        assert x["tokens"].dtype == y["tokens"].dtype
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_pipeline_prefetch_order():
    src = ({"x": np.full((2,), i, np.float32)} for i in range(5))
    out = list(DataPipeline(src, depth=3, device="cpu"))
    assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    jsrc = ({"x": np.full((2,), i, np.float32)} for i in range(5))
    assert [int(b["x"][0]) for b in JDataPipeline(jsrc, depth=3)] == [0, 1, 2, 3, 4]
    twice = DataPipeline([(np.arange(3), np.ones(2))], depth=2,
                         transform=lambda b: (b[0] * 2, b[1]), device="cpu")
    for _ in range(2):  # a list is restartable
        (got,) = list(twice)
        assert got[0].tolist() == [0, 2, 4]


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch.launch import train

    arch = get_config("minicpm-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        materialize(arch, arch.shape("train_4k"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DataPipeline([np.zeros(2)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])
    for arch_id, shape in (("dlrm-rm2", "serve_p99"), ("meshgraphnet", "molecule")):
        arch = get_config(arch_id)
        with pytest.raises(RuntimeError, match="CUDA"):
            materialize(arch, arch.shape(shape))
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", arch_id, "--smoke", "--steps", "1"])


# -------------------------------------------------------- CLI and example
def test_train_cli_recovers_an_injected_failure(tmp_path, capsys):
    from repro_torch.launch import train

    report = train.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "12",
                         "--ckpt-dir", str(tmp_path / "ck"), "--inject-failure", "5"])
    out = capsys.readouterr().out.splitlines()
    assert report.restarts == 1 and report.steps_done == 12
    assert re.fullmatch(r"arch=minicpm-2b steps=12 restarts=1 stragglers=\d+ wall=\S+s", out[-2])
    assert out[-1].startswith("loss trajectory: [") and len(report.losses) == 5 + 12
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == \
        ["step_00000010", "step_00000012"]
    assert str(train.DEFAULT_CKPT_DIR).endswith("build/train_ckpt")


@pytest.mark.parametrize("arch_id,steps,interval,fail,kept", [
    ("dlrm-rm2", 12, 10, 5, ["step_00000010", "step_00000012"]),
    # the smoke full_graph_sm cell scatters 131,072 edges: fewer steps
    ("meshgraphnet", 7, 2, 3, ["step_00000006", "step_00000007"]),
])
def test_train_cli_recovers_a_recsys_and_a_gnn_failure(tmp_path, capsys, arch_id, steps,
                                                        interval, fail, kept):
    from repro_torch.launch import train

    report = train.main(["--arch", arch_id, "--smoke", "--device", "cpu", "--steps", str(steps),
                         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-interval", str(interval),
                         "--inject-failure", str(fail)])
    out = capsys.readouterr().out.splitlines()
    assert report.restarts == 1 and report.steps_done == steps
    assert re.fullmatch(rf"arch={arch_id} steps={steps} restarts=1 stragglers=\d+ wall=\S+s",
                        out[-2])
    replayed = fail - (fail // interval) * interval  # steps redone from the last save
    assert out[-1].startswith("loss trajectory: [") and len(report.losses) == steps + replayed
    assert all(np.isfinite(report.losses))
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == kept


def test_train_cli_batches_are_the_reference_materialize_batches():
    from repro.launch.demo import materialize as jmaterialize
    from repro_torch.launch import train

    arch, jarch = get_config("minicpm-2b"), jget_config("minicpm-2b")
    cell, _ = materialize(arch, arch.shape("train_4k"), smoke=True, device="cpu")
    batches = train.build_batches(arch, cell, True, torch.device("cpu"))
    for step in (0, 4):
        want = jmaterialize(jarch, jarch.shape("train_4k"), smoke=True, seed=step)[1][-1]
        got = batches(step)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_example_trains_and_recovers(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--params", "10", "--steps", "24", "--batch", "2", "--seq", "16",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restarts=1" in out and "loss decreased" in out
