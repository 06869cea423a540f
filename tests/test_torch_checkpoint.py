"""The port's checkpoints against the JAX package's, on the CPU.

``TestCheckpoint`` is the reference's own suite (``tests/test_substrates.py``)
on the port. Then a checkpoint written by either package opens in the
other, bit for bit: minicpm's smoke params (f32, and cast to bf16) with f32,
bf16 and int8 ``AdamWState``s, a bf16 leaf beside them and the int32 step.
The port holds one tensor a layer where the reference stacks L of them; the
files hold the reference's stacked leaves in its flatten order, so the
leaf counts, shapes, dtypes and bytes agree. The same holds for the train
states of a recommender (dlrm-rm2, wide-deep) and of MeshGraphNet. Then the manager's rotation
and resume. Every test writes under its own ``tmp_path`` and waits for its
async saves before it asserts.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy, state_to_numpy
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves


def _bits(a) -> np.ndarray:
    """An array's bytes as unsigned integers (bf16 and f32 compared by bits)."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same_leaves(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, i
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"leaf {i}")


# ------------------------------------------------------- the reference's suite
class TestCheckpoint:
    def _tree(self, seed=0):
        r = np.random.default_rng(seed)
        return {
            "w": torch.from_numpy(r.standard_normal((16, 8)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(r.standard_normal(4)).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
        }

    def _zeros(self):
        return {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else self._zeros_of(v))
                for k, v in self._tree().items()}

    @staticmethod
    def _zeros_of(d):
        return {k: torch.zeros_like(v) for k, v in d.items()}

    def test_roundtrip_bitwise(self, tmp_path):
        t = self._tree()
        save_checkpoint(tmp_path, 10, t)
        fresh = self._zeros()
        got, mani = load_checkpoint(tmp_path, fresh)
        assert mani["step"] == 10 and got is fresh
        for a, b in zip(tree_leaves(t), tree_leaves(got)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)

    def test_async_and_rotation(self, tmp_path):
        mgr = CheckpointManager(tmp_path, interval=2, keep=2, async_save=True)
        t = self._tree()
        for step in range(1, 9):
            mgr.save(step, t)
        mgr.finalize()
        steps = sorted(p.name for p in tmp_path.glob("step_*"))
        assert len(steps) == 2 and steps[-1] == "step_00000008"

    def test_async_save_snapshots_before_it_returns(self, tmp_path):
        """Training overwrites its tensors in place right after an async
        save: the files hold the values at the time of the call."""
        t = self._tree()
        want = {"w": t["w"].clone()}
        save_checkpoint(tmp_path, 1, {"w": t["w"]}, blocking=False)
        t["w"].add_(1.0)
        ckpt.wait_for_pending()
        got, _ = load_checkpoint(tmp_path, {"w": torch.zeros(16, 8)})
        assert torch.equal(got["w"], want["w"])

    def test_atomicity_garbage_ignored(self, tmp_path):
        t = self._tree()
        save_checkpoint(tmp_path, 5, t)
        # a crashed partial write leaves a temp dir — must be invisible
        (tmp_path / ".tmp_ckpt_dead").mkdir()
        (tmp_path / "step_00000009").mkdir()  # no manifest -> incomplete
        got, mani = load_checkpoint(tmp_path, self._zeros())
        assert mani["step"] == 5

    def test_template_mismatch_rejected(self, tmp_path):
        save_checkpoint(tmp_path, 1, self._tree())
        bad = {"w": torch.zeros((3, 3))}
        with pytest.raises(ValueError):
            load_checkpoint(tmp_path, bad)
        wrong_shape = self._zeros()
        wrong_shape["w"] = torch.ones(8, 16)
        with pytest.raises(ValueError, match="shape"):
            load_checkpoint(tmp_path, wrong_shape)
        assert torch.equal(wrong_shape["nested"]["b"], torch.zeros(4, dtype=torch.bfloat16))


# ------------------------------------------------------------ cross-opening
J_INIT = jax.jit(JT.init, static_argnums=1)


@functools.cache
def _reference_state(params_dtype: str, moments: str):
    """The reference's smoke minicpm params and an AdamWState three updates
    in (moments non-zero), a bf16 leaf, as numpy trees."""
    jcfg = jget_config("minicpm-2b").smoke_model
    if params_dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jp = J_INIT(jax.random.key(1), jcfg)
    ocfg = JA.AdamWConfig(lr=1e-2, moment_dtype=moments)
    opt = JA.adamw_init(jp, ocfg)
    rng = np.random.default_rng(2)
    upd = jax.jit(lambda g, s, p: JA.adamw_update(g, s, p, ocfg))
    for _ in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jp)
        _, opt = upd(g, opt, jp)
    extra = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    return jcfg, jax.device_get((jp, opt, {"bf16": extra}))


def _port_template(params_dtype: str, moments: str):
    cfg = get_config("minicpm-2b").smoke_model
    if params_dtype == "bf16":
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p = T.init(torch.Generator().manual_seed(9), cfg, device="cpu")
    return cfg, (p, adamw_init(p, AdamWConfig(moment_dtype=moments)),
                 {"bf16": torch.zeros(3, 5, dtype=torch.bfloat16)})


_CASES = [("f32", "f32"), ("f32", "int8"), ("bf16", "bf16"), ("bf16", "int8")]


@pytest.mark.parametrize("params_dtype,moments", _CASES)
def test_the_port_opens_a_reference_checkpoint(tmp_path, params_dtype, moments):
    _, ref = _reference_state(params_dtype, moments)
    jsave(tmp_path, 3, ref)
    _, tmpl = _port_template(params_dtype, moments)
    got, mani = load_checkpoint(tmp_path, tmpl)
    assert mani["step"] == 3 and got is tmpl
    assert int(tmpl[1].step) == 3 and tmpl[1].step.dtype == torch.int32
    _same_leaves(state_to_numpy(got), ref)


@pytest.mark.parametrize("params_dtype,moments", _CASES)
def test_the_reference_opens_a_port_checkpoint(tmp_path, params_dtype, moments):
    """The port's state (carried over from the reference's numpy trees, as
    the parity tests carry it) written by the port, read by the reference
    into a template of its own."""
    jcfg, ref = _reference_state(params_dtype, moments)
    cfg, _ = _port_template(params_dtype, moments)
    p = lm_params_from_numpy(ref[0], cfg, device="cpu")
    bf16 = torch.from_numpy(np.array(ref[2]["bf16"]).view(np.int16)).view(torch.bfloat16)
    state = (p, adamw_state_from_numpy(ref[1], p), {"bf16": bf16})
    save_checkpoint(tmp_path, 3, state, blocking=False)
    ckpt.wait_for_pending()
    mani = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert mani["n_leaves"] == len(jax.tree.leaves(ref))
    jtmpl = jax.tree.map(jnp.zeros_like, ref)
    got, jmani = jload(tmp_path, jtmpl)
    assert jmani["step"] == 3
    _same_leaves(jax.tree.leaves(got), ref)
    _same_leaves(state_to_numpy(state), ref)


def test_the_manifest_names_the_reference_dtypes(tmp_path):
    _, ref = _reference_state("bf16", "int8")
    jsave(tmp_path / "ref", 3, ref)
    cfg, _ = _port_template("bf16", "int8")
    p = lm_params_from_numpy(ref[0], cfg, device="cpu")
    save_checkpoint(tmp_path / "port", 3, (p, adamw_state_from_numpy(ref[1], p),
                                           {"bf16": torch.zeros(3, 5, dtype=torch.bfloat16)}))
    want = json.loads((tmp_path / "ref" / "step_00000003" / "manifest.json").read_text())
    got = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    assert got["leaves"] == want["leaves"] and got["n_leaves"] == want["n_leaves"]
    assert {leaf["dtype"] for leaf in got["leaves"]} == {"bfloat16", "float32", "int8", "int32"}


# ------------------------------------------ recommender and GNN train states
@functools.cache
def _reference_model_state(arch_id: str):
    """The reference's smoke params of a recsys or GNN arch and an f32
    AdamWState three updates in, as numpy trees (lists of layers, the GNN's
    procs stacked on L, wide-deep's 0-d bias)."""
    from repro.models import gnn as JG
    from repro.models import recsys as JR

    jarch = jget_config(arch_id)
    init = JG.init if jarch.family == "gnn" else JR.init
    jp = jax.jit(init, static_argnums=1)(jax.random.key(1), jarch.smoke_model)
    ocfg = JA.AdamWConfig(lr=1e-2)
    opt = JA.adamw_init(jp, ocfg)
    rng = np.random.default_rng(3)
    upd = jax.jit(lambda g, st, q: JA.adamw_update(g, st, q, ocfg))
    for _ in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jp)
        _, opt = upd(g, opt, jp)
    return jax.device_get((jp, opt))


def _port_model_state(arch_id: str, ref=None):
    """The port's (params, AdamWState): over the reference's trees, or a
    fresh template of the same layout."""
    from repro_torch.convert import gnn_params_from_numpy, recsys_params_from_numpy
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R

    arch = get_config(arch_id)
    if ref is None:
        init = G.init if arch.family == "gnn" else R.init
        p = init(torch.Generator().manual_seed(9), arch.smoke_model, device="cpu")
        return p, adamw_init(p, AdamWConfig())
    convert = gnn_params_from_numpy if arch.family == "gnn" else recsys_params_from_numpy
    p = convert(ref[0], device="cpu")
    return p, adamw_state_from_numpy(ref[1], p)


_MODEL_ARCHS = ["dlrm-rm2", "wide-deep", "meshgraphnet"]


@pytest.mark.parametrize("arch_id", _MODEL_ARCHS)
def test_recsys_and_gnn_states_open_in_either_package(tmp_path, arch_id):
    """A train state written by the reference opens in the port, and one
    written by the port opens in the reference: leaf order (list order,
    then ``b`` before ``w``), shapes, dtypes and bits."""
    ref = _reference_model_state(arch_id)
    jsave(tmp_path / "ref", 3, ref)
    tmpl = _port_model_state(arch_id)
    got, mani = load_checkpoint(tmp_path / "ref", tmpl)
    assert mani["step"] == 3 and got is tmpl and int(tmpl[1].step) == 3
    _same_leaves(state_to_numpy(got), ref)

    save_checkpoint(tmp_path / "port", 3, _port_model_state(arch_id, ref), blocking=False)
    ckpt.wait_for_pending()
    jgot, jmani = jload(tmp_path / "port", jax.tree.map(jnp.zeros_like, ref))
    assert jmani["step"] == 3
    _same_leaves(jax.tree.leaves(jgot), ref)
    want = json.loads((tmp_path / "ref" / "step_00000003" / "manifest.json").read_text())
    port = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    assert port["leaves"] == want["leaves"]


def test_layer_lists_flatten_in_list_order_b_before_w():
    """A recsys MLP is a Python list of {"w", "b"} layers of different
    shapes: its leaves are the layers in order, each b then w, as the
    reference flattens them; nothing is stacked."""
    p, opt = _port_model_state("dlrm-rm2")
    leaves = tree_leaves(p)
    bot = p["bot"]
    assert leaves[:2 * len(bot)] == [t for lyr in bot for t in (lyr["b"], lyr["w"])]
    assert leaves[2 * len(bot)] is p["embed"]
    assert len(tree_leaves(opt)) == 1 + 2 * len(leaves)


# ------------------------------------------------------------------ manager
def test_manager_rotation_and_resume(tmp_path):
    t = {"w": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(tmp_path, interval=3, keep=2, async_save=True)
    assert [mgr.should_save(s) for s in (0, 1, 3, 6)] == [False, False, True, True]
    for step in range(1, 11):
        t["w"] += 1
        mgr.save(step, t, {"losses_len": step})
    mgr.finalize()
    assert mgr.saved_steps == [6, 9]
    again = CheckpointManager(tmp_path, interval=3, keep=2)
    assert again.saved_steps == [6, 9]
    fresh = {"w": torch.zeros(6)}
    got, step = again.restore_latest(fresh)
    assert step == 9 and got is fresh and torch.equal(fresh["w"], torch.arange(6.0) + 9)
    empty = CheckpointManager(tmp_path / "none")
    untouched = {"w": torch.ones(2)}
    assert empty.restore_latest(untouched) == (untouched, 0)
    assert torch.equal(untouched["w"], torch.ones(2))
