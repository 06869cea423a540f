"""Parity of repro_torch.core.sharded with repro.core.sharded.

The reference's mesh functions run once per module, in a subprocess with
eight host devices (``--xla_force_host_platform_device_count=8``, as
tests/test_sharded_knn.py runs them): this file, run as a script, writes
their answers to an ``.npz``. The port's functions run in this process on a
mesh of logical CPU devices (``["cpu"] * 8``), with ``backend="torch"``
(plain ops) and ``backend="cuda"`` (the kernels' plain versions on a CPU
tensor).

The inputs keep every score exact in f32, so values and indices must agree
bit for bit: integer rows for l2 and ip, rows of ±1 whose norms are powers
of two for cos (their normalisation is exact), int8 rows whose scale is 1
(so only the square root rounds). Rows 5,000 and up are invalid (+inf
norm): 5,120 rows split over 8 blocks of 640, which the kernels scan as 512
aligned rows and a tail. One exception, the reference's own (ROADMAP C):
among rows tied at the k boundary ``lax.top_k`` keeps them by position, so
there the port must hold, as many as the reference kept, the smallest ids
of that score (the documented contract), read off an exact numpy oracle.
"""
from __future__ import annotations

import math
import os
import pathlib
import subprocess
import sys

import numpy as np

N, N_VALID, D, M = 5120, 5000, 32, 8
MESHES = ((4, 2), (2, 2), (1, 1))
METRICS = ("l2", "ip", "cos")
KS = (1, 13, 100)
F32_FNS = ("fdsq_sharded", "fqsd_sharded", "fqsd_ring", "fqsd_ring_queries")
#: the dataset axes each function reads its rows over
ROW_AXES = {"fdsq_sharded": ("data", "model"), "fqsd_sharded": ("model",),
            "fqsd_ring": ("data", "model"), "fqsd_ring_queries": ("data", "model")}


def _pow2_rows(rng, n, d):
    """Rows of ±1 with 1, 4 or 16 nonzeros: norms 1, 2 or 4 (exact cos)."""
    counts = rng.choice([1, 4, 16], n)
    ranks = rng.random((n, d)).argsort(1).argsort(1)
    return ((ranks < counts[:, None]) * rng.choice([-1.0, 1.0], (n, d))).astype(np.float32)


def f32_inputs(metric: str):
    """(queries (M, D), rows (N, D), norms (N,)) with planted duplicates."""
    rng = np.random.default_rng(11 + METRICS.index(metric))
    if metric == "cos":
        x, q = _pow2_rows(rng, N, D), _pow2_rows(rng, M, D)
    else:
        x = rng.integers(-8, 9, (N, D)).astype(np.float32)
        q = rng.integers(-8, 9, (M, D)).astype(np.float32)
    x[N_VALID:] = 0.0
    x[4000] = x[17]  # duplicates in different blocks: ties decided by index
    x[900] = x[17]
    q[0] = x[17]
    norms = np.sum(x.astype(np.float64) ** 2, -1).astype(np.float32)
    norms[N_VALID:] = np.inf
    return q, x, norms


def int8_rows():
    """Rows in [-127, 127] with one entry at 127 (int8 scale exactly 1) and
    integer queries in [-8, 8]."""
    rng = np.random.default_rng(23)
    x = rng.integers(-127, 128, (N, D)).astype(np.float32)
    x[np.arange(N), rng.integers(0, D, N)] = 127.0
    x[4000] = x[17]
    q = rng.integers(-8, 9, (M, D)).astype(np.float32)
    q[0] = x[17]
    return q, x


def f32_cases():
    """(fn, mesh shape, metric, k): every function on every mesh and metric,
    k rotating so each (function, metric) meets every k."""
    return [(fn, shape, metric, KS[(si + mi) % len(KS)])
            for fn in F32_FNS for si, shape in enumerate(MESHES)
            for mi, metric in enumerate(METRICS)]


def int8_cases():
    return [(shape, r) for shape in MESHES for r in KS]


def case_key(*parts) -> str:
    return "|".join(str(p) for p in parts)


def exact_scores(q, x, norms, metric) -> np.ndarray:
    """Every (query, row) score in float64, exact for these inputs (+inf
    on invalid rows)."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if metric == "l2":
        s = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    elif metric == "ip":
        s = -(q64 @ x64.T)
    else:
        qn = np.sqrt((q64 ** 2).sum(-1))
        xn = np.sqrt((x64 ** 2).sum(-1))
        s = 1.0 - (q64 @ x64.T) / (qn[:, None] * np.where(xn > 0, xn, 1.0)[None])
    return np.where(np.isfinite(norms)[None], s, np.inf)


def assert_same(got_s, got_i, ref_s, ref_i, scores) -> None:
    """Values bit for bit; indices bit for bit but in the tie group at the
    k boundary, where the port holds the smallest ids of that score."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    assert np.array_equal(got_s, ref_s)
    tied = (ref_s == ref_s[:, -1:]) & np.isfinite(ref_s)
    assert np.array_equal(got_i[~tied], ref_i[~tied])
    for r in np.flatnonzero(tied.any(1)):
        want = np.flatnonzero(scores[r] == ref_s[r, -1])[: int(tied[r].sum())]
        assert np.array_equal(got_i[r][tied[r]], want), r


# ----------------------------------------------------- the reference side
def _reference(out: str) -> None:
    import jax

    from repro import compat
    from repro.core import sharded as jsh
    from repro.core.quantized import quantize_dataset

    devices = jax.devices()
    assert len(devices) == 8, devices
    meshes = {shape: compat.make_mesh(shape, ("data", "model"),
                                      devices=devices[: math.prod(shape)])
              for shape in MESHES}
    res = {}
    for fn, shape, metric, k in f32_cases():
        q, x, norms = f32_inputs(metric)
        mesh = meshes[shape]
        axes = ROW_AXES[fn]
        build = getattr(jsh, fn)
        f = build(mesh, k, metric) if fn != "fdsq_sharded" else build(mesh, k, metric, axes)
        v, n = jsh.shard_dataset(mesh, x, norms, axes if len(axes) > 1 else axes[0])
        t = f(q, v, n)
        res[case_key(fn, shape, metric, k, "s")] = np.asarray(t.scores)
        res[case_key(fn, shape, metric, k, "i")] = np.asarray(t.indices)
    q, x = int8_rows()
    q8 = quantize_dataset(x)
    qnorm = np.asarray(q8.qnorm_sq).copy()
    qnorm[N_VALID:] = np.inf
    for name in ("q", "scales", "err", "qnorm_sq"):
        res[f"int8|{name}"] = np.asarray(getattr(q8, name))
    res["int8|qnorm"] = qnorm
    for shape, r in int8_cases():
        mesh = meshes[shape]
        f = jsh.fdsq_sharded_int8(mesh, r, ("data", "model"))
        t = f(q, np.asarray(q8.q), np.asarray(q8.scales), np.asarray(q8.err), qnorm)
        res[case_key("int8", shape, r, "s")] = np.asarray(t.scores)
        res[case_key("int8", shape, r, "i")] = np.asarray(t.indices)
    np.savez(out, **res)


if __name__ == "__main__":
    _reference(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------- the port side
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import sharded as tsh  # noqa: E402
from repro_torch.core.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.core.streaming import make_ring_put  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's answers, computed once per module in a subprocess."""
    out = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(out))


def _mesh(shape) -> Mesh:
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * math.prod(shape))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _build(fn, mesh, k, metric, backend):
    if fn == "fdsq_sharded":
        return tsh.fdsq_sharded(mesh, k, metric, ROW_AXES[fn], backend=backend)
    return getattr(tsh, fn)(mesh, k, metric, backend=backend)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("fn,shape,metric,k", f32_cases())
def test_f32_mesh_functions_match_the_reference(ref, fn, shape, metric, k, backend):
    q, x, norms = f32_inputs(metric)
    mesh = _mesh(shape)
    v, n = tsh.shard_dataset(mesh, _t(x), _t(norms), ROW_AXES[fn])
    got = _build(fn, mesh, k, metric, backend)(_t(q), v, n)
    assert_same(got.scores, got.indices, ref[case_key(fn, shape, metric, k, "s")],
                ref[case_key(fn, shape, metric, k, "i")], exact_scores(q, x, norms, metric))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape,r", int8_cases())
def test_int8_mesh_bounds_match_the_reference(ref, shape, r, backend):
    q, _ = int8_rows()
    mesh = _mesh(shape)
    codes = _t(ref["int8|q"])
    chans = [_t(ref[f"int8|{name}"]) for name in ("scales", "err", "qnorm")]
    got = tsh.fdsq_sharded_int8(mesh, r, ("data", "model"), backend=backend)(
        _t(q), codes, *chans)
    assert got.scores.shape == (M, r + 1)
    # the bounds in f32 as both packages round them: d_hat is an exact
    # integer (scale 1, err 0), its square root correctly rounded, squared
    acc = q.astype(np.float64) @ ref["int8|q"].astype(np.float64).T
    d_hat = ((q.astype(np.float64) ** 2).sum(-1)[:, None] - 2 * acc
             + ref["int8|qnorm_sq"][None]).astype(np.float32)
    root = np.sqrt(np.maximum(d_hat, np.float32(0)))
    lower = np.where(np.isfinite(ref["int8|qnorm"])[None], root * root, np.inf)
    assert_same(got.scores, got.indices, ref[case_key("int8", shape, r, "s")],
                ref[case_key("int8", shape, r, "i")], lower)


# ------------------------------------------------- placement and the ring put
@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")), ((4, 2), ("model",)),
                                        ((2, 2), ("model", "data")), ((1, 1), ("data",))])
def test_shard_dataset_places_row_major_blocks(shape, axes):
    """Block b holds rows [b·rows, (b+1)·rows) of a row-major order over the
    axes; positions that differ only on other axes share their block."""
    mesh = _mesh(shape)
    x = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    v, n = tsh.shard_dataset(mesh, x, x[:, 0], axes)
    nb = math.prod(mesh.shape[ax] for ax in axes)
    rows = 64 // nb
    assert v.n_blocks == nb and v.rows == rows and v.shape == (64, 3)
    assert torch.equal(v.full(), x) and torch.equal(n.full(), x[:, 0])
    for p, coord in enumerate(np.ndindex(mesh.devices.shape)):
        b = 0
        for ax in axes:
            b = b * mesh.shape[ax] + coord[mesh.axis_names.index(ax)]
        assert torch.equal(v.local[p], x[b * rows: (b + 1) * rows])
        assert v.local[p].data_ptr() == x[b * rows:].data_ptr()  # a view, not a copy
    with pytest.raises(ValueError, match="split"):
        tsh.shard_dataset(_mesh((4, 2)), x[:63], x[:63, 0], ("data", "model"))
    with pytest.raises(ValueError, match="no axis"):
        tsh.shard_dataset(mesh, x, x[:, 0], ("rows",))


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")), ((2, 2), ("data",))])
def test_local_scan_offsets_are_the_global_rows(shape, axes):
    """Every block's queue carries global row ids: the nearest row of a query
    copied from row j is j, wherever j's block lies."""
    mesh = _mesh(shape)
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (1024, 16)).astype(np.float32)
    rows = [3, 200, 511, 777, 1023]
    q = x[rows]
    v, n = tsh.shard_dataset(mesh, _t(x), _t(np.sum(x * x, -1)), axes)
    for backend in ("torch", "cuda"):
        got = tsh.fdsq_sharded(mesh, 1, "l2", axes, backend=backend)(_t(q), v, n)
        assert got.indices[:, 0].tolist() == rows and got.scores[:, 0].tolist() == [0.0] * 5


def test_ring_put_goes_round_robin_and_fires_the_fault_hook(monkeypatch):
    from repro_torch.core import streaming
    from repro_torch.core.partition import PaddedDataset

    seen = []
    monkeypatch.setattr(streaming, "_on_device_put",
                        lambda p: seen.append(getattr(p, "base_index", None)))
    put = make_ring_put(["cpu", "cpu", "meta"])
    parts = [PaddedDataset(torch.ones(4, 2), torch.ones(4), 4, 4 * i) for i in range(5)]
    out = [put(p) for p in parts]
    assert [o.vectors.device.type for o in out] == ["cpu", "cpu", "meta", "cpu", "cpu"]
    assert [o.base_index for o in out] == [0, 4, 8, 12, 16] and seen == [0, 4, 8, 12, 16]
    assert torch.equal(out[0].vectors, parts[0].vectors)
    fresh = make_ring_put(["meta", "cpu"])  # a new ring starts at device 0
    assert fresh(torch.ones(2)).device.type == "meta"
    with pytest.raises(ValueError, match="at least one"):
        make_ring_put([])


def test_mesh_hashes_by_devices_and_axes():
    a = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    b = make_mesh((2, 2), ("data", "model"), devices=[torch.device("cpu")] * 4)
    c = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    assert a == b and hash(a) == hash(b) and a != c
    assert a.shape == {"data": 2, "model": 2} and a.size == 4
    assert a.axis_names == ("data", "model") and a.first == torch.device("cpu")
    with pytest.raises(ValueError, match="one type"):
        make_mesh((2,), ("data",), devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="needs 4"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh((2,), ("data",))
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1,), ("data",), devices=["cuda:0"])
