"""The port's optimizer, schedules and gradient compression against the JAX
package's on the CPU.

``TestAdamW`` and ``TestCompression`` are the reference's own substrate
tests (``tests/test_substrates.py``) on the port. The parity cases put the
same seeded numpy inputs through both packages:

* ``adamw_update`` on qwen2.5's smoke param tree (QKV biases; layer
  weights stacked in the reference, one tensor a layer in the port), three
  steps of the same gradients, for f32, bf16 and int8 moments, with and
  without the clip and weight decay. f32 moments: updates within
  ``rtol=1e-5`` of the largest update of their leaf. The elementwise math
  is the same ops in the same order in both packages; what differs is the
  global norm's sum (stacked leaves there, per-layer ones here, summed in
  another order) and ``b1 ** step`` in f32, each an ulp or so. bf16 and
  int8 moments round that ulp into a moment now and then, so they are held
  to the rounding step of their format: a bf16 moment's 2^-8 of itself, an
  int8 moment's 1/127 of its row's largest value, which moves an update by
  at most about that share of its leaf's largest update (``5e-3`` and
  ``2e-2`` of it). Measured, as a share of the leaf's largest update: f32
  3.7e-07, bf16 2.7e-03, int8 9.7e-04 (with the clip; 3.7e-07 at most
  without it, whatever the moments).
* weight decay by the reference's stacked rank: with zero gradients only
  decay moves a weight, and the (L, d) ``ln1`` scales and (L, H·dh) QKV
  biases of the reference move while ``final_norm``'s (d,) does not.
* the schedules at steps 0..N, within ``rtol=1e-6`` (f32 transcendentals
  of two libraries);
* ``compress_int8`` bit-equal (the codes and scales of the same f32 math);
* the row-chunked update of a large leaf bit-equal to the whole-leaf one.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedules as JS
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.optim import schedules as S
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, apply_updates
from repro_torch.optim.compression import (
    ErrorFeedback, compress_int8, compress_with_feedback, decompress_int8, decompress_tree,
)
from repro_torch.tree import tree_leaves


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------- the reference's suite
class TestAdamW:
    @pytest.mark.parametrize("md", ["f32", "bf16", "int8"])
    def test_converges_quadratic(self, md):
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype=md)
        p = {"w": _t(np.random.default_rng(0).standard_normal((8, 16)))}
        st = adamw_init(p, cfg)
        for _ in range(200):
            g = {"w": p["w"].clone()}  # grad of ||p||^2/2
            u, st = adamw_update(g, st, p, cfg)
            p = apply_updates(p, u)
        assert float(p["w"].abs().mean()) < 0.05

    def test_int8_moments_track_f32(self):
        rng = np.random.default_rng(1)
        w0 = rng.standard_normal((32, 64))
        cfg8 = AdamWConfig(lr=0.01, moment_dtype="int8", grad_clip=None)
        cfg32 = AdamWConfig(lr=0.01, moment_dtype="f32", grad_clip=None)
        p8, p32 = {"w": _t(w0)}, {"w": _t(w0)}
        s8, s32 = adamw_init(p8, cfg8), adamw_init(p32, cfg32)
        for _ in range(20):
            g = {"w": _t(rng.standard_normal((32, 64)))}
            u8, s8 = adamw_update(g, s8, p8, cfg8)
            u32, s32 = adamw_update(g, s32, p32, cfg32)
            p8, p32 = apply_updates(p8, u8), apply_updates(p32, u32)
        rel = float((p8["w"] - p32["w"]).abs().mean() / p32["w"].abs().mean())
        assert rel < 0.05, rel

    def test_grad_clip(self):
        cfg = AdamWConfig(lr=1.0, grad_clip=1.0)
        p = {"w": torch.zeros(4)}
        st = adamw_init(p, cfg)
        huge = {"w": torch.full((4,), 1e6)}
        u, _ = adamw_update(huge, st, p, cfg)
        assert float(u["w"].abs().max()) < 10.0  # clipped, not 1e6-scaled

    def test_update_is_in_place(self):
        """The new state holds the old state's moment tensors, and
        apply_updates writes into the parameters it is given."""
        p = {"w": _t(np.ones((2, 3)))}
        w = p["w"]
        st = adamw_init(p, AdamWConfig(moment_dtype="int8"))
        m_q = st.m["w"].q
        u, st2 = adamw_update({"w": _t(np.full((2, 3), 0.5))}, st, p)
        assert st2.m["w"].q is m_q and int(st2.step) == 1 and int(st.step) == 0
        assert apply_updates(p, u) is p and p["w"] is w and not torch.equal(w, torch.ones(2, 3))


class TestCompression:
    def test_roundtrip_error_bounded(self):
        x = _t(np.random.default_rng(0).standard_normal((16, 256)))
        c = compress_int8(x)
        err = (decompress_int8(c) - x).abs()
        assert float(err.max()) <= float(x.abs().amax(1).max()) / 127 + 1e-6

    def test_error_feedback_removes_bias(self):
        """Sum of decompressed grads with EF converges to the true sum."""
        rng = np.random.default_rng(2)
        g_true = _t(rng.standard_normal((8, 128)) * 0.01)
        grads = {"w": g_true}
        ef = ErrorFeedback.init(grads)
        acc = torch.zeros_like(g_true)
        n = 50
        for _ in range(n):
            comp, ef = compress_with_feedback(grads, ef)
            acc = acc + decompress_tree(comp, grads)["w"]
        rel = float((acc - n * g_true).abs().mean() / (n * g_true).abs().mean())
        assert rel < 0.02, rel


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("shape", [(16, 256), (7,), ()])
def test_compress_int8_is_bit_equal(shape):
    x = np.asarray(np.random.default_rng(3).standard_normal(shape) * 3, dtype=np.float32)
    got, want = compress_int8(torch.from_numpy(x)), JC.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(decompress_int8(got).numpy(),
                                  np.asarray(JC.decompress_int8(want)))
    ref = JA._q8_encode(jnp.asarray(x))
    np.testing.assert_array_equal(A._q8_encode(torch.from_numpy(x)).q.numpy(), np.asarray(ref.q))


def test_error_feedback_is_the_reference():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((4, 32)).astype(np.float32)
    comp, ef = compress_with_feedback({"w": torch.from_numpy(g)},
                                      ErrorFeedback.init({"w": torch.from_numpy(g)}))
    jcomp, jef = JC.compress_with_feedback({"w": jnp.asarray(g)},
                                           JC.ErrorFeedback.init({"w": jnp.asarray(g)}))
    np.testing.assert_array_equal(comp["w"].q.numpy(), np.asarray(jcomp["w"].q))
    np.testing.assert_array_equal(ef.residual["w"].numpy(), np.asarray(jef.residual["w"]))


_SCHEDULES = [
    ("constant", dict(lr=3e-4)),
    ("cosine_schedule", dict(peak_lr=3e-4, warmup=5, total=40, floor=1e-5)),
    ("wsd_schedule", dict(peak_lr=3e-4, warmup=5, stable=10, decay=20)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULES, ids=[s[0] for s in _SCHEDULES])
def test_schedules_equal_the_reference(name, kw):
    steps = np.arange(0, 50, dtype=np.int32)
    f, jf = getattr(S, name)(**kw), jax.jit(jax.vmap(getattr(JS, name)(**kw)))
    got = np.array([float(f(torch.tensor(s))) for s in steps], np.float32)
    assert f(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(got, np.broadcast_to(np.asarray(jf(jnp.asarray(steps))),
                                                    got.shape), rtol=1e-6, atol=0)


@functools.cache
def _smoke_params(arch: str):
    """The reference's smoke params as numpy (f32), and the port's over them."""
    jcfg, cfg = jget_config(arch).smoke_model, get_config(arch).smoke_model
    jp = jax.tree.map(np.asarray, jax.jit(JT.init, static_argnums=1)(jax.random.key(0), jcfg))
    return jcfg, jp, cfg


def _grads_like(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)


def _port_grads(p, jgrads):
    """The reference's stacked gradients as the port's dict by parameter name."""
    return state_from_numpy(jgrads, {n: torch.zeros_like(t) for n, t in p.named_parameters()})


@functools.cache
def _jit_update(cfg_items):
    cfg = JA.AdamWConfig(**dict(cfg_items))
    return jax.jit(lambda g, s, p: JA.adamw_update(g, s, p, cfg))


_CONFIGS = [dict(grad_clip=None, weight_decay=0.0), dict(grad_clip=1.0, weight_decay=0.1),
            dict(grad_clip=0.05, weight_decay=0.1)]
#: moments -> share of a leaf's largest update an update may be off by
_UPDATE_TOL = {"f32": 1e-5, "bf16": 5e-3, "int8": 2e-2}


@pytest.mark.parametrize("kw", _CONFIGS, ids=["plain", "clip+decay", "clipping+decay"])
@pytest.mark.parametrize("moments", ["f32", "bf16", "int8"])
def test_adamw_update_on_a_smoke_tree(moments, kw):
    """Three steps on qwen2.5's smoke params, the same gradients in both
    packages; the clip of 0.05 binds on every step (the gradients' norm is
    ~60), the one of 1.0 too."""
    jcfg, jp, cfg = _smoke_params("qwen2.5-14b")
    p = lm_params_from_numpy(jp, cfg, device="cpu")
    kw = dict(kw, lr=1e-2, moment_dtype=moments)
    st, jst, jparams = adamw_init(p, AdamWConfig(**kw)), JA.adamw_init(jp, JA.AdamWConfig(**kw)), jp
    for step in range(3):
        jgrads = _grads_like(jp, 10 + step)
        u, st = adamw_update(_port_grads(p, jgrads), st, p, AdamWConfig(**kw))
        ju, jst = _jit_update(tuple(sorted(kw.items())))(jgrads, jst, jparams)
        for got, want in zip(tree_leaves(state_to_numpy(u)), jax.tree.leaves(ju)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=_UPDATE_TOL[moments] * np.abs(want).max())
        p = apply_updates(p, u)
        jparams = jax.jit(JA.apply_updates)(jparams, ju)
        assert int(st.step) == int(jst.step) == step + 1
    for got, want in zip(tree_leaves(state_to_numpy(p)), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=3 * 1e-2 * _UPDATE_TOL[moments] + 1e-6)


def test_weight_decay_goes_by_the_reference_rank():
    """Zero gradients: only weight decay moves a weight. ln1/ln2 scales and
    the QKV biases are (L, d) leaves in the reference and decay; the final
    norm's (d,) does not; the port agrees leaf for leaf."""
    jcfg, jp, cfg = _smoke_params("qwen2.5-14b")
    rng = np.random.default_rng(5)
    # non-zero norms and biases, so that a decay shows
    jp = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.1).astype(np.float32), jp)
    p = lm_params_from_numpy(jp, cfg, device="cpu")
    kw = dict(lr=0.5, weight_decay=0.1, grad_clip=None)
    zeros = {n: torch.zeros_like(t) for n, t in p.named_parameters()}
    u, _ = adamw_update(zeros, adamw_init(p, AdamWConfig(**kw)), p, AdamWConfig(**kw))
    ju, _ = _jit_update(tuple(sorted(kw.items())))(
        jax.tree.map(np.zeros_like, jp), JA.adamw_init(jp, JA.AdamWConfig(**kw)), jp)
    for name in ("layers.0.ln1.scale", "layers.1.ln2.scale", "layers.0.attn.bq"):
        assert p.reference_ndim(name) == 2 and u[name].abs().max() > 0, name
    assert p.reference_ndim("final_norm.scale") == 1
    assert torch.equal(u["final_norm.scale"], torch.zeros_like(u["final_norm.scale"]))
    np.testing.assert_array_equal(u["layers.1.attn.bk"].numpy(), np.asarray(ju["layers"]["attn"]["bk"][1]))
    for got, want in zip(tree_leaves(state_to_numpy(u)), jax.tree.leaves(ju)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("moments", ["f32", "bf16", "int8"])
def test_row_chunked_update_is_bit_equal_to_the_whole_leaf(moments, monkeypatch):
    """A leaf of more than CHUNK_ELEMS elements is updated in row chunks
    (a full-size embedding table's f32 temporaries would not fit beside
    it). With the chunk forced to 7 rows of a (50, 6) table (8 chunks, the
    last short), a (50, 1) table and a (3, 4, 5) leaf, the updates, the
    moments and the params after three steps are bit-equal to the
    whole-leaf update's; the 0-d and 1-d leaves are never split."""
    rng = np.random.default_rng(11)
    shapes = {"table": (50, 6), "wide": (50, 1), "stack": (3, 4, 5), "b": (6,), "bias": ()}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0, moment_dtype=moments)
    runs = []
    for chunk in (A.CHUNK_ELEMS, 42):
        monkeypatch.setattr(A, "CHUNK_ELEMS", chunk)
        p = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
        st = adamw_init(p, cfg)
        us = []
        for step in range(3):
            g = {k: torch.from_numpy(np.random.default_rng(step).standard_normal(s)
                                     .astype(np.float32)) for k, s in shapes.items()}
            u, st = adamw_update(g, st, p, cfg)
            us.append(u)
            p = apply_updates(p, u)
        runs.append((us, st, p))
    assert A._chunk_rows(runs[1][2]["table"]) == 7
    (us0, st0, p0), (us1, st1, p1) = runs
    for a, b in zip(tree_leaves((us0, st0, p0)), tree_leaves((us1, st1, p1))):
        assert a.dtype == b.dtype and torch.equal(a, b)
