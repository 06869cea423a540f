"""The model substrate on a mesh: the port's islands and sharded cells held
to the reference's on the same mesh.

The reference runs once per module, in a subprocess with eight host
devices (``--xla_force_host_platform_device_count=8``), under
``compat.use_mesh``: this file, run as a script, writes its answers to an
``.npz``. The port runs in this process on a mesh of logical CPU devices
(``["cpu"] * n``) under ``repro_torch.core.mesh.use_mesh``. The meshes are
(data=1, model=8) and (data=2, model=4). Inputs are drawn from seeds with
numpy; LM weights come from the reference's ``init`` (the same key in both
processes) through ``convert.lm_params_from_numpy``.

Tolerances, stated per case:

* ``_flash_decode_sharded`` (f32): ``rtol=2e-6, atol=2e-7``. Both sum the
  positions' statistics in f32, in other orders inside each position.
* ``_moe_manual``: within one bf16 ulp of each element. The combine is the
  reference's bf16 ``psum``: each position's f32 sum rounded to bf16, the
  positions' values summed in f32 and rounded once (``XLA-CPU`` sums a
  bf16 all-reduce so: measured, the port's sum gives its bits exactly); a
  position's f32 sum may round the other way where its last bit differs.
  The aux loss: ``rtol=1e-6``.
* the row-sharded ``embedding_lookup``: bit-identical (one position holds
  each row, the others add +0.0).
* whole ``prefill`` + ``decode_step``: the port's mesh logits within
  ``MODEL_TOL`` of the reference's mesh logits, and closer to them than
  the reference's own mesh logits are to its meshless ones (the gap the
  bf16 combine opens). Both numbers are printed.
* one train step's loss (``rtol=1e-5``) and grads (smoke qwen3-moe and
  dlrm on (2, 4)), each leaf's within a share of its largest value:
  ``LM_TRAIN_TOL`` (1e-3) for the MoE model, whose backward carries the
  combine's cotangent in bf16 as the reference's does, so a value that
  rounds the other way moves others by a bf16 step (measured: at most
  2.8e-4, on the head); ``DLRM_TRAIN_TOL`` (1e-6) for dlrm, f32 throughout
  (measured: at most 2.7e-7).
* the kNN cells on ``["cpu"] * 4``: bit-identical to the meshless cells
  and, in values, to the reference's mesh cells, on integer data; indices
  too, but for rows tied at the k boundary, which the reference keeps by
  position and the port by smallest id (ROADMAP C).
"""
from __future__ import annotations

import contextlib
import math
import os
import pathlib
import subprocess
import sys

import numpy as np

MESHES = ((1, 8), (2, 4))
FD = dict(b=4, s=32, h=4, kvh=2, dh=16, clen=20)  # flash-decode case
MOE = dict(b=4, s=6, d=32, e=16, de=16, top_k=2, cf=1.25)
TABLE = (384, 8)
LMS = ("qwen3-moe-30b-a3b", "minicpm-2b")
PROMPT, MAX_LEN, STEPS = 8, 16, 4
KNN_MESH = (2, 2)
KNN_SHAPES = ("gist_fqsd", "msmarco_fdsq", "msmarco_k72", "yfcc_ring", "yfcc_ring_q")
MODEL_TOL = 1e-3
LM_TRAIN_TOL, DLRM_TRAIN_TOL = 1e-3, 1e-6


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def fd_inputs():
    c = FD
    return (_normal(1, c["b"], 1, c["h"], c["dh"]), _normal(2, c["b"], c["s"], c["kvh"], c["dh"]),
            _normal(3, c["b"], c["s"], c["kvh"], c["dh"]))


def moe_inputs():
    c = MOE
    params = {"router": _normal(4, c["d"], c["e"]) * 0.5,
              "w_gate": _normal(5, c["e"], c["d"], c["de"]) / math.sqrt(c["d"]),
              "w_up": _normal(6, c["e"], c["d"], c["de"]) / math.sqrt(c["d"]),
              "w_down": _normal(7, c["e"], c["de"], c["d"]) / math.sqrt(c["de"])}
    return params, _normal(8, c["b"], c["s"], c["d"])


def table_inputs():
    rng = np.random.default_rng(9)
    return _normal(10, *TABLE), rng.integers(0, TABLE[0], (8, 5)).astype(np.int32)


def lm_tokens(vocab):
    return np.random.default_rng(11).integers(0, vocab, (2, PROMPT + STEPS)).astype(np.int32)


def dlrm_batch(cfg):
    rng = np.random.default_rng(12)
    b = 8
    sparse = np.stack([rng.integers(0, s, b) for s in cfg.table_sizes], -1).astype(np.int32)
    return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
            "sparse": sparse, "label": rng.integers(0, 2, b).astype(np.float32)}


def knn_inputs(cell_inputs):
    """Integer-valued queries and rows (every score exact in f32) of the
    cell's padded shapes, with duplicates planted for ties."""
    rng = np.random.default_rng(13)
    (m, d), (n, _) = cell_inputs[0].shape, cell_inputs[1].shape
    q = rng.integers(-4, 5, (m, d)).astype(np.float32)
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    x[n // 2] = x[7]
    q[0] = x[7]
    return q, x, (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)


def _flat(prefix, tree, out):
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf, np.float32)


# ------------------------------------------------------ the reference side
def _reference(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import get_config
    from repro.launch.steps import build_cell
    from repro.models import layers as JL
    from repro.models import recsys as JR
    from repro.models import transformer as JT

    def mesh_of(shape):
        n = shape[0] * shape[1]
        return compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n])

    res = {}
    q, k, v = fd_inputs()
    mp, mx = moe_inputs()
    table, ids = table_inputs()
    for shape in MESHES:
        mesh, tag = mesh_of(shape), f"{shape[0]}x{shape[1]}"
        with compat.use_mesh(mesh):
            fd = jax.jit(lambda q, k, v: JL._flash_decode_sharded(
                q, k, v, jnp.int32(FD["clen"]), mesh=mesh, n_heads=FD["h"],
                n_kv_heads=FD["kvh"], d_head=FD["dh"]))
            res[f"fd|{tag}"] = np.asarray(fd(q, k, v))
            y, aux = jax.jit(lambda p, x: JL.moe(p, x, n_experts=MOE["e"], top_k=MOE["top_k"],
                                                  capacity_factor=MOE["cf"]))(mp, mx)
            res[f"moe|{tag}|y"], res[f"moe|{tag}|aux"] = np.asarray(y), np.asarray(aux)
            res[f"emb|{tag}"] = np.asarray(jax.jit(JR.embedding_lookup)(table, ids))

    init = jax.jit(JT.init, static_argnums=1)
    prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
    decode = jax.jit(JT.decode_step, static_argnums=1)
    for arch in LMS:
        cfg = get_config(arch).smoke_model
        p = init(jax.random.key(0), cfg)
        tok = lm_tokens(cfg.vocab)
        for shape in (None,) + MESHES:
            ctx = compat.use_mesh(mesh_of(shape)) if shape else contextlib.nullcontext()
            tag = f"{shape[0]}x{shape[1]}" if shape else "meshless"
            with ctx:
                logits, cache = prefill(p, cfg, jnp.asarray(tok[:, :PROMPT]), MAX_LEN)
                steps = [np.asarray(logits)]
                for pos in range(PROMPT, PROMPT + STEPS):
                    logits, cache = decode(p, cfg, cache, jnp.asarray(tok[:, pos:pos + 1]))
                    steps.append(np.asarray(logits))
            res[f"lm|{arch}|{tag}"] = np.stack(steps)

    with compat.use_mesh(mesh_of((2, 4))):
        cfg = get_config("qwen3-moe-30b-a3b").smoke_model
        p = init(jax.random.key(0), cfg)
        tok = lm_tokens(cfg.vocab)
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(p, cfg, b), has_aux=True))(p, {"tokens": jnp.asarray(tok)})
        res["train|lm|loss"] = np.asarray(loss)
        _flat("train|lm|g", g, res)
        cfg = get_config("dlrm-rm2").smoke_model
        p = jax.jit(JR.init, static_argnums=1)(jax.random.key(0), cfg)
        batch = {k_: jnp.asarray(v_) for k_, v_ in dlrm_batch(cfg).items()}
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: JR.loss_fn(p, cfg, b), has_aux=True))(p, batch)
        res["train|dlrm|loss"] = np.asarray(loss)
        _flat("train|dlrm|g", g, res)

    arch = get_config("knn-search")
    with compat.use_mesh(mesh_of(KNN_MESH)):
        for name in KNN_SHAPES:
            cell = build_cell(arch, arch.shape(name), smoke=True)
            got = jax.jit(cell.fn)(*map(jnp.asarray, knn_inputs(cell.inputs)))
            res[f"knn|{name}|s"], res[f"knn|{name}|i"] = map(np.asarray, got)
    np.savez(out, **res)


if __name__ == "__main__":
    _reference(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------- the port side
import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, recsys_params_from_numpy  # noqa: E402
from repro_torch.core.mesh import make_mesh, use_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import requires_grad_, tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's answers, computed once per module in a subprocess."""
    out = tmp_path_factory.mktemp("model_mesh_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(out))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * math.prod(shape))


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("shape", MESHES)
def test_flash_decode_sharded(ref, shape):
    q, k, v = map(_t, fd_inputs())
    got = L._flash_decode_sharded(q, k, v, FD["clen"], mesh=_mesh(shape), n_heads=FD["h"],
                                  n_kv_heads=FD["kvh"], d_head=FD["dh"])
    np.testing.assert_allclose(got.numpy(), ref[f"fd|{_tag(shape)}"], rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("shape", MESHES)
def test_moe_manual(ref, shape):
    mp, mx = moe_inputs()
    with use_mesh(_mesh(shape)):
        y, aux = L.moe({k: _t(v) for k, v in mp.items()}, _t(mx), n_experts=MOE["e"],
                       top_k=MOE["top_k"], capacity_factor=MOE["cf"])
    want = ref[f"moe|{_tag(shape)}|y"]
    err = np.abs(y.numpy() - want)
    assert (err <= _bf16_ulp(want)).all(), f"{int((err > _bf16_ulp(want)).sum())} elements"
    np.testing.assert_allclose(aux.numpy(), ref[f"moe|{_tag(shape)}|aux"], rtol=1e-6)


def test_moe_manual_needs_experts_that_split():
    mp, mx = moe_inputs()
    with use_mesh(_mesh((1, 8))), pytest.raises(ValueError, match="not divisible"):
        L.moe({k: _t(v)[:12] if k != "router" else _t(v)[:, :12] for k, v in mp.items()},
              _t(mx), n_experts=12, top_k=2)


@pytest.mark.parametrize("shape", MESHES)
def test_row_sharded_embedding_lookup(ref, shape):
    table, ids = table_inputs()
    with use_mesh(_mesh(shape)):
        got = R.embedding_lookup(_t(table), _t(ids)).numpy()
    assert np.array_equal(got.view(np.int32), ref[f"emb|{_tag(shape)}"].view(np.int32))
    assert np.array_equal(got, table[ids])


def _lm(arch):
    jcfg, cfg = jget_config(arch).smoke_model, get_config(arch).smoke_model
    jp = jax.jit(JT.init, static_argnums=1)(jax.random.key(0), jcfg)
    return cfg, lm_params_from_numpy(jp, cfg, device="cpu")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", LMS)
def test_prefill_and_decode_on_the_mesh(ref, arch, shape):
    cfg, p = _lm(arch)
    tok = _t(lm_tokens(cfg.vocab))
    with use_mesh(_mesh(shape)):
        logits, cache = T.prefill(p, cfg, tok[:, :PROMPT], MAX_LEN)
        steps = [logits]
        for pos in range(PROMPT, PROMPT + STEPS):
            logits, cache = T.decode_step(p, cfg, cache, tok[:, pos:pos + 1])
            steps.append(logits)
    got = torch.stack(steps).numpy()
    want, meshless = ref[f"lm|{arch}|{_tag(shape)}"], ref[f"lm|{arch}|meshless"]
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    port_gap = float(np.abs(got[fin] - want[fin]).max())
    ref_gap = float(np.abs(want[fin] - meshless[fin]).max())
    print(f"{arch} {_tag(shape)}: port mesh vs reference mesh {port_gap:.3e}; reference "
          f"mesh vs its meshless {ref_gap:.3e}")
    assert port_gap <= MODEL_TOL
    if cfg.is_moe:  # the bf16 combine opens a gap the port must stay inside
        assert port_gap < ref_gap


def _tree_close(got: dict, ref, prefix, tol):
    for key, want in ((k, v) for k, v in ref.items() if k.startswith(prefix)):
        path = [p.strip("[]'") for p in key[len(prefix):].split("]") if p]
        g = got
        for part in path:
            g = g[int(part)] if isinstance(g, list) else g[part]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.to(torch.float32).numpy() / scale, want / scale,
                                   rtol=0, atol=tol, err_msg=key)


def test_train_step_grads_on_the_mesh(ref):
    """Loss and grads of one step of smoke qwen3-moe and dlrm on (2, 4)."""
    from repro_torch.tree import reference_layout, tree_map

    cfg, p = _lm("qwen3-moe-30b-a3b")
    p.requires_grad_(True)
    with use_mesh(_mesh((2, 4))):
        (loss, _), g = T.value_and_grad(p, cfg, {"tokens": _t(lm_tokens(cfg.vocab))})
    np.testing.assert_allclose(loss.numpy(), ref["train|lm|loss"], rtol=1e-5)
    stacked = tree_map(lambda s: torch.stack(s.parts) if hasattr(s, "parts") else s,
                       reference_layout(g))
    _tree_close(stacked, ref, "train|lm|g", LM_TRAIN_TOL)

    jcfg, cfg = jget_config("dlrm-rm2").smoke_model, get_config("dlrm-rm2").smoke_model
    jp = jax.jit(JR.init, static_argnums=1)(jax.random.key(0), jcfg)
    p = requires_grad_(recsys_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    with use_mesh(_mesh((2, 4))):
        (loss, _), g = R.value_and_grad(p, cfg, {k: _t(v) for k, v in dlrm_batch(cfg).items()})
    np.testing.assert_allclose(loss.numpy(), ref["train|dlrm|loss"], rtol=1e-5)
    _tree_close(g, ref, "train|dlrm|g", DLRM_TRAIN_TOL)
    assert all(torch.isfinite(t).all() for t in tree_leaves(g))


@pytest.mark.parametrize("name", KNN_SHAPES)
def test_knn_cells_on_the_mesh(ref, name):
    arch = get_config("knn-search")
    with use_mesh(_mesh(KNN_MESH)):
        cell = build_cell(arch, arch.shape(name), smoke=True)
        q, x, xn = map(_t, knn_inputs(cell.inputs))
        got = cell.fn(q, x, xn)
    want = build_cell(arch, arch.shape(name), smoke=True).fn(q, x, xn)
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)
    scores, ids = got.scores.numpy(), got.indices.numpy()
    assert np.array_equal(scores, ref[f"knn|{name}|s"])
    # the reference's own quirk (ROADMAP C): rows tied at the k boundary are
    # kept by position, where the port keeps the smallest ids of that score
    last = scores[:, -1:]
    inner = scores < last
    assert np.array_equal(ids[inner], ref[f"knn|{name}|i"][inner])
    exact = ((q.double()[:, None, :] - x.double()[None]) ** 2).sum(-1).numpy()
    for r in range(scores.shape[0]):
        tied = np.flatnonzero(exact[r] == last[r, 0])
        assert np.array_equal(np.sort(ids[r][~inner[r]]), tied[: int((~inner[r]).sum())])


def test_two_tower_retrieval_cell_over_row_sharded_candidates():
    """On (1, 4) the candidates are P("model", None) and go through
    fdsq_sharded(metric="ip"): the meshless cell's answer (scores to f32
    rounding: BLAS blocks a row block's products in its own order)."""
    from repro_torch.launch import demo

    arch = get_config("two-tower-retrieval")
    shape = arch.shape("retrieval_cand")
    cell, args = demo.materialize(arch, shape, smoke=True, seed=3, device="cpu")
    want = cell.fn(*args)
    with use_mesh(_mesh((1, 4))):
        mcell = build_cell(arch, shape, smoke=True)
        got = mcell.fn(*args)
    assert tuple(mcell.in_specs[2]) == ("model", None)
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got.indices, want.indices)
