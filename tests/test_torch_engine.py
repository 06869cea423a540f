"""The slice as a whole: the port's ``ExactKNN.search`` against the JAX
engine over the same state.

A JAX ``ExactKNN`` is fitted on numpy data and the port's engine is built
over its resident padded arrays with ``repro_torch.convert`` (device
"cpu", so the fused executor runs the kernel's plain version). Integer
data in [-4, 4] keeps every score exact, so results must be bit-identical:
values, indices and tie order, for mode_hint fdsq and fqsd, per-request k,
filter masks and cos (rows whose norms are powers of two normalise
exactly). Plans agree field by field once executor and backend names are
mapped.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.types import SearchRequest as JRequest
from repro.core.engine import ExactKNN as JExactKNN
from repro_torch import ExactKNN, SearchRequest
from repro_torch.convert import engine_state_from_jax, padded_from_numpy
from repro_torch.core import executors as tex
from repro_torch.kernels.knn import kernel as K

_EXEC = {"fdsq-torch": "fdsq-xla", "fqsd-torch": "fqsd-xla", "fdsq-cuda": "fdsq-pallas"}
_BACKEND = {"torch": "xla", "cuda": "pallas"}


def _ints(rng, shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = _ints(rng, (1500, 40))
    x[900], x[1400] = x[12], x[12]  # exact ties, broken to the smaller index
    q = _ints(rng, (6, 40))
    q[0] = x[12]
    mask = rng.random(1500) > 0.3
    return x, q, mask


def _oracle(x, q, k, mask=None):
    """Full-sort kNN in float64 (exact on integer data): ties go to the
    smaller index, the documented contract."""
    q = np.atleast_2d(q).astype(np.float64)
    s = ((q[:, None, :] - x[None].astype(np.float64)) ** 2).sum(-1)
    if mask is not None:
        s[:, ~mask] = np.inf
    order = np.lexsort((np.broadcast_to(np.arange(len(x)), s.shape), s), axis=-1)
    return order[:, :k]


def _same_result(got, want, oracle=None):
    """Bit-identical values; bit-identical indices, except that the
    reference's plain fdsq path (``tree_merge_sorted`` selecting with
    ``lax.top_k``) may break a tie at the k boundary by position: there the
    port must give the full-sort order."""
    v, i = got.topk.scores.numpy(), got.topk.indices.numpy()
    wv, wi = np.asarray(want.topk.scores), np.asarray(want.topk.indices)
    np.testing.assert_array_equal(v, wv)
    if oracle is None:
        np.testing.assert_array_equal(i, wi)
    else:
        np.testing.assert_array_equal(i, oracle)
        inside = wv < wv[:, -1:]
        np.testing.assert_array_equal(i[inside], wi[inside])
    plan = dataclasses.asdict(got.plan)
    plan["executor"], plan["backend"] = _EXEC[plan["executor"]], _BACKEND[plan["backend"]]
    assert plan == dataclasses.asdict(want.plan)
    assert got.stats["bytes_scanned"] == want.stats["bytes_scanned"]
    for key in ("k", "metric", "m", "batched", "partial", "health"):
        assert got.stats[key] == want.stats[key]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_search_matches_reference_engine(data, backend):
    """fused (fdsq-cuda vs fdsq-pallas) and plain (fdsq-torch / fqsd-torch vs
    fdsq-xla / fqsd-xla) executors over one state, every request option."""
    x, q, mask = data
    jeng = JExactKNN(k=5, backend=_BACKEND[backend]).fit(x)
    teng = engine_state_from_jax(jeng, device="cpu")
    assert teng.backend == backend and teng.n == jeng.n and teng.n_ids == jeng.n_ids
    requests = [
        dict(queries=q[0], mode_hint="fdsq"),
        dict(queries=q, mode_hint="fqsd"),
        dict(queries=q, mode_hint="fqsd", k=3, filter_mask=mask),
        dict(queries=q[:2], k=9),  # auto -> fdsq
    ]
    for kw in requests:
        got = teng.search(SearchRequest(**kw))
        want = jeng.search(JRequest(**kw))
        _same_result(got, want, _oracle(x, kw["queries"], kw.get("k", 5),
                                        kw.get("filter_mask")))
        assert (got.kernel_stats is None) == (want.kernel_stats is None)
    if backend == "cuda":
        assert {p.executor for p in teng.plans} == {"fdsq-cuda"}
        bm, bn, bd = teng.last_kernel_stats["blocks"]
        assert (bn, bd) == tuple(jeng.last_kernel_stats["blocks"][1:])
        assert 0.0 <= float(teng.last_kernel_stats["prune_skip_rate"]) <= 1.0
    else:
        assert [p.executor for p in teng.plans] == [
            "fdsq-torch", "fqsd-torch", "fqsd-torch", "fdsq-torch"]


def test_cos_engine_matches_reference():
    rng = np.random.default_rng(22)
    x = np.zeros((700, 64), np.float32)
    for r in range(700):  # +-1 entries, counts 1/4/16: norms are powers of 2
        c = rng.choice([1, 4, 16])
        x[r, rng.choice(64, c, replace=False)] = rng.choice([-1.0, 1.0], c)
    q = x[[3, 500]] * 2.0
    jeng = JExactKNN(k=6, metric="cos", backend="pallas").fit(x)
    teng = engine_state_from_jax(jeng, device="cpu")
    assert teng._cos_prenormalized
    for mode in ("fdsq", "fqsd"):
        _same_result(teng.search(SearchRequest(queries=q, mode_hint=mode)),
                     jeng.search(JRequest(queries=q, mode_hint=mode)))
    with pytest.raises(ValueError, match="normalised"):
        teng.search(SearchRequest(queries=q, metric="l2"))


def test_port_fit_builds_the_reference_state(data):
    """fit() on numpy data pads exactly as the reference does, and a cos
    engine normalises its resident rows at fit time."""
    x, q, _ = data
    jeng = JExactKNN(k=4, backend="pallas").fit(x)
    teng = ExactKNN(k=4, backend="cuda", device="cpu").fit(x)
    np.testing.assert_array_equal(teng._ds.vectors.numpy(), np.asarray(jeng._ds.vectors))
    np.testing.assert_array_equal(teng._ds.norms.numpy(), np.asarray(jeng._ds.norms))
    assert teng.store.n_main == teng.store.n_live == teng.n_ids == 1500
    assert teng.store.mutation_count == 0 and teng.store.has_tier("f32")
    assert teng.store.nbytes() == 2048 * 128 * 4
    carried = engine_state_from_jax(jeng, device="cpu")
    assert teng.plan_for("fqsd", m=6) == carried.plan_for("fqsd", m=6)
    # a tensor already on the engine's device is padded there, not copied
    t = torch.from_numpy(x)
    teng2 = ExactKNN(k=4, backend="cuda", device="cpu").fit(t)
    assert torch.equal(teng2._ds.vectors, teng._ds.vectors)
    cos = ExactKNN(k=4, metric="cos", backend="cuda", device="cpu").fit(x)
    norms = torch.linalg.vector_norm(cos._ds.vectors[:1500], dim=-1)
    torch.testing.assert_close(norms, torch.ones(1500), rtol=1e-6, atol=1e-6)


def test_executable_cache_does_not_grow_on_repeats_or_mode_switches(data):
    x, q, _ = data
    tex.clear_executable_cache()
    eng = ExactKNN(k=5, backend="cuda", device="cpu").fit(x)
    for mode in ("fdsq", "fqsd"):
        eng.search(SearchRequest(queries=q, mode_hint=mode))
    plain = ExactKNN(k=5, backend="torch", device="cpu").fit(x)
    for mode in ("fdsq", "fqsd"):
        plain.search(SearchRequest(queries=q, mode_hint=mode))
    size = tex.cache_info()["size"]
    assert size == 3  # fdsq-cuda serves both modes with one entry
    for _ in range(2):
        for e in (eng, plain):
            for mode in ("fqsd", "fdsq"):
                e.search(SearchRequest(queries=q, mode_hint=mode))
    info = tex.cache_info()
    assert info["size"] == size and info["misses"] == size and info["hits"] == 9
    tex.set_executable_cache_limit(1)
    assert tex.cache_info()["evictions"] == 2
    tex.set_executable_cache_limit(256)
    tex.clear_executable_cache()


def test_engine_refuses_what_this_slice_lacks(data):
    x, q, _ = data
    eng = ExactKNN(k=3, device="cpu").fit(x)
    with pytest.raises(RuntimeError, match="enable_int8"):
        eng.search(SearchRequest(queries=q, tier="int8"))
    with pytest.raises(NotImplementedError, match="store"):
        eng.upsert(x[:2])
    # out-of-core stores are ported now (tests/test_torch_streaming.py)
    streamed = ExactKNN(k=3, device="cpu").fit_store(eng.store, resident=False)
    assert streamed.search(SearchRequest(queries=q)).plan.executor == "fqsd-mmap-streamed"
    with pytest.raises(NotImplementedError, match="mesh"):
        ExactKNN(k=3, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="filter_mask"):
        eng.search(SearchRequest(queries=q, filter_mask=np.ones(7, bool)))
    with pytest.raises(TypeError):
        eng.search(q)


def test_padded_from_numpy_carries_state():
    v = np.arange(24, dtype=np.float32).reshape(6, 4)
    n = np.array([1, 2, 3, 4, np.inf, np.inf], np.float32)
    p = padded_from_numpy(v, n, 4, 10, device="cpu")
    assert torch.equal(p.vectors, torch.from_numpy(v)) and p.norms.dtype == torch.float32
    assert torch.isinf(p.norms[4:]).all() and (p.n_valid, p.base_index) == (4, 10)
    bf = padded_from_numpy(jnp.asarray(v, jnp.bfloat16), n, 4, device="cpu")  # no numpy bf16
    assert bf.vectors.dtype == torch.bfloat16
    assert torch.equal(bf.vectors.float(), torch.from_numpy(v))


def test_launch_counter_untouched_on_cpu(data):
    x, q, _ = data
    K.reset_launch_counts()
    ExactKNN(k=2, backend="cuda", device="cpu").fit(x).search(SearchRequest(queries=q))
    assert sum(K.LAUNCHES.values()) == 0
