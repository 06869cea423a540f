"""Port vs reference on the core modules: top-k, distances, padding, the
bitonic networks, planning and the request types.

Every input is made with numpy from a seed and handed to both packages on
the CPU. Top-k selection and the bitonic networks promise bit-identity
(values, indices and tie order); the distance matrices go through a matrix
product summed in another order, so they agree within the reference's own
kernel tolerance (rtol=1e-5, atol=1e-4). Scores stay clear of subnormals,
which the reference's CPU sort treats as zero.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import types as jtypes
from repro.core import distance as jdist
from repro.core import fdsq as jfdsq
from repro.core import fqsd as jfqsd
from repro.core import partition as jpart
from repro.core import planner as jplanner
from repro.core import topk as jtopk
from repro.data import synthetic as jsynth
from repro.kernels import bitonic as jbit
from repro_torch.api import types as ttypes
from repro_torch.core import distance as tdist
from repro_torch.core import fdsq as tfdsq
from repro_torch.core import fqsd as tfqsd
from repro_torch.core import partition as tpart
from repro_torch.core import planner as tplanner
from repro_torch.core import topk as ttopk
from repro_torch.data import synthetic as tsynth
from repro_torch.kernels import bitonic as tbit


def _np(t):
    return np.asarray(t)


def _tie_scores(rng, shape, lo=-6, hi=7):
    """Integer-valued f32 scores with many exact ties, +inf and -0.0."""
    s = rng.integers(lo, hi, shape).astype(np.float32)
    s[rng.random(shape) < 0.1] = np.inf
    s[(s == 0) & (rng.random(shape) < 0.5)] = -0.0
    return s


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


# ------------------------------------------------------------------ topk
@pytest.mark.parametrize("shape", [(5, 37), (3, 4, 64)])
def test_sort_pairs_matches_reference(shape):
    rng = np.random.default_rng(0)
    s = _tie_scores(rng, shape)
    i = rng.permutation(np.prod(shape)).reshape(shape).astype(np.int32)
    js, ji = jtopk.sort_pairs(jnp.asarray(s), jnp.asarray(i))
    ts, ti = ttopk.sort_pairs(torch.from_numpy(s), torch.from_numpy(i))
    _same(ts, js)
    _same(ti, ji)


def test_sort_pairs_orders_negative_zero_as_zero():
    s = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0]])
    i = torch.arange(6, dtype=torch.int32)[None]
    _, ti = ttopk.sort_pairs(s, i)
    assert ti.tolist() == [[5, 0, 1, 3, 4, 2]]


@pytest.mark.parametrize("n,k", [(50, 7), (64, 64), (10, 16), (300, 1)])
def test_topk_smallest_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    s = rng.integers(-5, 6, (4, n)).astype(np.float32)  # ties, no -0.0
    s[rng.random(s.shape) < 0.05] = np.inf
    i = np.broadcast_to(np.arange(n, dtype=np.int32), s.shape).copy()
    js, ji = jtopk.topk_smallest(jnp.asarray(s), jnp.asarray(i), k)
    ts, ti = ttopk.topk_smallest(torch.from_numpy(s), torch.from_numpy(i), k)
    _same(ts, js)
    _same(ti, ji)


def test_topk_smallest_is_the_full_sort_prefix():
    """The documented contract on shuffled indices and -0.0 ties: the k
    smallest (score, index) pairs, exactly the prefix of a full sort."""
    rng = np.random.default_rng(1)
    s = _tie_scores(rng, (6, 200))
    i = rng.permutation(1200).reshape(6, 200).astype(np.int32)
    js, ji = jtopk.sort_pairs(jnp.asarray(s), jnp.asarray(i))
    ts, ti = ttopk.topk_smallest(torch.from_numpy(s), torch.from_numpy(i), 33)
    _same(ts, _np(js)[:, :33])
    _same(ti, _np(ji)[:, :33])


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(2)
    s0, i0 = np.sort(rng.integers(-3, 4, (3, 8)).astype(np.float32), -1), None
    i0 = np.arange(24, dtype=np.int32).reshape(3, 8)
    cs = rng.integers(-3, 4, (3, 40)).astype(np.float32)
    ci = (100 + np.arange(120, dtype=np.int32)).reshape(3, 40)
    js, ji = jtopk.sort_pairs(jnp.asarray(s0), jnp.asarray(i0))
    jout = jtopk.merge_topk(jtopk.TopK(js, ji), jnp.asarray(cs), jnp.asarray(ci))
    tout = ttopk.merge_topk(ttopk.TopK(torch.from_numpy(_np(js).copy()),
                                       torch.from_numpy(_np(ji).copy())),
                            torch.from_numpy(cs), torch.from_numpy(ci))
    _same(tout.scores, jout.scores)
    _same(tout.indices, jout.indices)


@pytest.mark.parametrize("parts", [1, 2, 5])
def test_tree_merge_sorted_matches_reference(parts):
    """Distinct scores against the reference; tie-heavy scores against the
    full-sort prefix (the reference's ``lax.top_k`` may break ties at the k
    boundary by position once the tree reorders partitions)."""
    rng = np.random.default_rng(parts)
    k = 16
    i = np.arange(parts * 3 * 40, dtype=np.int32).reshape(parts, 3, 40)
    distinct = rng.permutation(i.size).reshape(i.shape).astype(np.float32)
    ties = rng.integers(-4, 5, i.shape).astype(np.float32)
    for s in (distinct, ties):
        ls, li = (_np(a) for a in jtopk.sort_pairs(jnp.asarray(s), jnp.asarray(i)))
        ls, li = ls[..., :k].copy(), li[..., :k].copy()
        tout = ttopk.tree_merge_sorted(torch.from_numpy(ls), torch.from_numpy(li))
        if s is distinct:
            jout = jtopk.tree_merge_sorted(jnp.asarray(ls), jnp.asarray(li))
        else:
            flat = lambda a: np.moveaxis(a, 0, -2).reshape(3, -1)  # noqa: E731
            jout = [a[:, :k] for a in jtopk.sort_pairs(jnp.asarray(flat(s)),
                                                       jnp.asarray(flat(i)))]
            jout = jtopk.TopK(*jout)
        _same(tout.scores, jout.scores)
        _same(tout.indices, jout.indices)


def test_empty_topk_and_knn_oracle():
    e = ttopk.empty_topk((2, 3), 4)
    je = jtopk.empty_topk((2, 3), 4)
    _same(e.scores, je.scores)
    _same(e.indices, je.indices)
    rng = np.random.default_rng(3)
    s = rng.integers(0, 9, (5, 30)).astype(np.float32)
    js, ji = jtopk.knn_oracle(jnp.asarray(s), 6, base_index=1000)
    ts, ti = ttopk.knn_oracle(torch.from_numpy(s), 6, base_index=1000)
    _same(ts, js)
    _same(ti, ji)


# -------------------------------------------------------------- distance
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_pairwise_scores_match_reference(metric):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((7, 48)).astype(np.float32)
    x = rng.standard_normal((90, 48)).astype(np.float32)
    x[5] = 0.0  # a zero row: cos distance 1
    want = jdist.pairwise_scores(jnp.asarray(q), jnp.asarray(x), metric)
    got = tdist.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x), metric)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_pairwise_scores_with_norms_and_bf16():
    rng = np.random.default_rng(5)
    q = rng.integers(-4, 5, (3, 32)).astype(np.float32)
    x = rng.integers(-4, 5, (20, 32)).astype(np.float32)
    xn = (x * x).sum(-1).astype(np.float32)
    for metric in ("l2", "ip"):  # integer inputs: exact in f32
        want = jdist.pairwise_scores(jnp.asarray(q), jnp.asarray(x), metric,
                                     x_norms=jnp.asarray(xn))
        got = tdist.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x), metric,
                                    x_norms=torch.from_numpy(xn))
        _same(got, want)
    got = tdist.pairwise_scores(torch.from_numpy(q).bfloat16(),
                                torch.from_numpy(x).bfloat16(), "l2")
    want = jdist.pairwise_scores(jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(x, jnp.bfloat16), "l2")
    assert got.dtype == torch.float32
    _same(got, want)


def test_validate_metric():
    for mod in (tdist, jdist):
        with pytest.raises(ValueError, match="metric"):
            mod.validate_metric("hamming")


# ------------------------------------------------------ plain FD-SQ / FQ-SD
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_scans_match_reference(metric):
    """fqsd_scan, fdsq_search and the per-partition step over one padded
    state with +inf rows; integer data, so bit-identical."""
    rng = np.random.default_rng(6)
    x = rng.integers(-4, 5, (500, 24)).astype(np.float32)
    x[300] = x[7]
    q = jpart.pad_dim(rng.integers(-4, 5, (3, 24)).astype(np.float32), 128)
    p = jpart.make_padded(x, row_mult=256)  # 512 x 128, 12 rows of padding
    norms = np.asarray(p.norms).copy()
    norms[7] = np.inf  # a tombstone on the norms channel
    jv, jn = p.vectors, jnp.asarray(norms)
    tv, tn = torch.from_numpy(np.array(jv)), torch.from_numpy(norms)
    tq = torch.from_numpy(q)
    want = jfqsd.fqsd_scan(jnp.asarray(q), jv, jn, 9, metric, chunk_rows=128)
    got = tfqsd.fqsd_scan(tq, tv, tn, 9, metric, chunk_rows=128)
    _same(got.scores, want.scores)
    _same(got.indices, want.indices)
    fd = tfdsq.fdsq_search(tq, tv, tn, 9, metric, n_partitions=4)
    _same(fd.scores, want.scores)
    _same(fd.indices, want.indices)
    step = tfqsd.make_partition_step(9, metric)
    state = ttopk.empty_topk((3,), 9)
    for base in (0, 256):
        state = step(state, tq, tv[base:base + 256], tn[base:base + 256], base, 256)
    _same(state.scores, want.scores)
    _same(state.indices, want.indices)


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("n,d,row_mult", [(300, 40, 128), (1024, 128, 1024), (1, 3, 128)])
def test_make_padded_matches_reference(n, d, row_mult):
    rng = np.random.default_rng(n)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    j = jpart.make_padded(x, base_index=7, row_mult=row_mult)
    t = tpart.make_padded(torch.from_numpy(x), base_index=7, row_mult=row_mult)
    _same(t.vectors, j.vectors)
    _same(t.norms, j.norms)
    assert (t.n_valid, t.base_index) == (j.n_valid, j.base_index)


def test_partition_helpers_match_reference():
    for v in (0, 1, 3, 128, 129, 1000):
        assert tpart.next_pow2(v) == jpart.next_pow2(v)
        assert tpart.round_up(v, 128) == jpart.round_up(v, 128)
        assert tpart.aligned_shape(v, v + 1) == jpart.aligned_shape(v, v + 1)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    _same(tpart.pad_dim(torch.from_numpy(x), 8), jpart.pad_dim(x, 8))
    _same(tpart.pad_rows(torch.from_numpy(x), 5), jpart.pad_rows(x, 5))
    assert tpart.LANE == jpart.LANE


# --------------------------------------------------------------- bitonic
def _pairs(rng, rows, L):
    v = _tie_scores(rng, (rows, L), -3, 4)
    i = rng.permutation(rows * L).reshape(rows, L).astype(np.int32)
    return v, i


@pytest.mark.parametrize("L", [1, 2, 8, 128])
def test_bitonic_sort_bit_identical(L):
    rng = np.random.default_rng(L)
    v, i = _pairs(rng, 5, L)
    jv, ji = jbit.bitonic_sort(jnp.asarray(v), jnp.asarray(i))
    tv, ti = tbit.bitonic_sort(torch.from_numpy(v), torch.from_numpy(i))
    _same(tv, jv)
    _same(ti, ji)
    assert np.array_equal(np.signbit(_np(tv)), np.signbit(_np(jv)))


@pytest.mark.parametrize("L", [2, 64])
def test_bitonic_merge_and_topk_update_bit_identical(L):
    rng = np.random.default_rng(100 + L)
    bv, bi = _pairs(rng, 4, L)
    cv, ci = _pairs(rng, 4, L)
    bv, bi = (_np(a) for a in jbit.bitonic_sort(jnp.asarray(bv), jnp.asarray(bi)))
    cv, ci = (_np(a) for a in jbit.bitonic_sort(jnp.asarray(cv), jnp.asarray(ci)))
    jv, ji = jbit.topk_update(*(jnp.asarray(a) for a in (bv, bi, cv, ci)))
    tv, ti = tbit.topk_update(*(torch.from_numpy(a.copy()) for a in (bv, bi, cv, ci)))
    _same(tv, jv)
    _same(ti, ji)
    # a bitonic input: ascending then descending
    seq_v = np.concatenate([bv, cv[:, ::-1]], -1)[:, ::2].copy()
    seq_i = np.concatenate([bi, ci[:, ::-1]], -1)[:, ::2].copy()
    jv, ji = jbit.bitonic_merge_ascending(jnp.asarray(seq_v), jnp.asarray(seq_i))
    tv, ti = tbit.bitonic_merge_ascending(torch.from_numpy(seq_v), torch.from_numpy(seq_i))
    _same(tv, jv)
    _same(ti, ji)


def test_sort_topk_tile_and_tile_prunable_match_reference():
    rng = np.random.default_rng(7)
    v, i = _pairs(rng, 4, 16)
    jv, ji = jbit.sort_topk_tile(jnp.asarray(v), jnp.asarray(i), 8)
    tv, ti = tbit.sort_topk_tile(torch.from_numpy(v), torch.from_numpy(i), 8)
    _same(tv, jv)
    _same(ti, ji)
    tile = rng.integers(0, 10, (4, 64)).astype(np.float32)
    for worst in (tile.min(-1) - 1, tile.min(-1), tile.min(-1) + 1):  # strict >
        queue = np.sort(rng.integers(-20, -10, (4, 8)), -1).astype(np.float32)
        queue[:, -1] = worst
        want = bool(jbit.tile_prunable(jnp.asarray(tile), jnp.asarray(queue)))
        got = bool(tbit.tile_prunable(torch.from_numpy(tile), torch.from_numpy(queue)))
        assert got == want
    with pytest.raises(ValueError, match="power-of-two"):
        tbit.bitonic_sort(torch.zeros(1, 6), torch.zeros(1, 6, dtype=torch.int32))


# --------------------------------------------------------------- planner
_EXEC = {"fdsq-torch": "fdsq-xla", "fqsd-torch": "fqsd-xla", "fdsq-cuda": "fdsq-pallas"}
_BACKEND = {"torch": "xla", "cuda": "pallas"}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode", ["fdsq", "fqsd"])
@pytest.mark.parametrize("rows", [8192, 3072, 1000448])
def test_plan_matches_reference(backend, mode, rows):
    meta_kw = dict(padded_rows=rows, padded_dim=1024, n_valid=rows - 5)
    tp = tplanner.plan((3, 1024), tplanner.DatasetMeta(**meta_kw),
                       tplanner.EngineConfig(k=10, backend=backend, chunk_rows=4096,
                                             n_partitions=6), mode, k=7, metric="ip")
    jp = jplanner.plan((3, 1024), jplanner.DatasetMeta(**meta_kw),
                       jplanner.EngineConfig(k=10, backend=_BACKEND[backend],
                                             chunk_rows=4096, n_partitions=6),
                       mode, k=7, metric="ip")
    got = dataclasses.asdict(tp)
    got["executor"], got["backend"] = _EXEC[got["executor"]], _BACKEND[got["backend"]]
    assert got == dataclasses.asdict(jp)
    assert tp.cache_key()[1:] == jp.cache_key()[1:]


def test_plan_rejects_what_this_slice_lacks():
    meta = tplanner.DatasetMeta(padded_rows=1024, padded_dim=128, n_valid=1000)
    cfg = tplanner.EngineConfig(k=4)
    with pytest.raises(TypeError, match="bogus"):
        tplanner.plan((1, 128), meta, cfg, "fdsq", bogus=1)
    # non-resident plans stream now; a bare DatasetMeta has no store behind it
    streamed = tplanner.plan((1, 128), dataclasses.replace(meta, resident=False), cfg, "fqsd")
    assert (streamed.executor, streamed.mode) == ("fqsd-streamed", "fqsd-streamed")
    with pytest.raises(NotImplementedError, match="mesh"):
        tplanner.plan((1, 128), dataclasses.replace(meta, sharded=True), cfg, "fdsq")
    with pytest.raises(ValueError, match="backend"):
        tplanner.plan((1, 128), meta, tplanner.EngineConfig(k=4, backend="pallas"), "fdsq")


@pytest.mark.parametrize("n,cap", [(1, 1), (12, 5), (97, 10), (1000448, 8192), (36, 0)])
def test_largest_divisor_matches_reference(n, cap):
    assert tplanner.largest_divisor_at_most(n, cap) == jplanner.largest_divisor_at_most(n, cap)


# ------------------------------------------------------------- api types
@pytest.mark.parametrize("kw", [
    dict(k=0), dict(tier="fp16"), dict(mode_hint="batch"), dict(prefetch_depth=0),
    dict(spec_trigger=1.5), dict(max_retries=-1),
])
def test_search_request_validation_matches_reference(kw):
    with pytest.raises(ValueError) as jerr:
        jtypes.SearchRequest(queries=np.zeros(4), **kw)
    with pytest.raises(ValueError) as terr:
        ttypes.SearchRequest(queries=np.zeros(4), **kw)
    assert str(terr.value) == str(jerr.value)


def test_search_request_counts_queries():
    assert ttypes.AUTO_FDSQ_MAX_BATCH == jtypes.AUTO_FDSQ_MAX_BATCH
    for q in (np.zeros(4), np.zeros((3, 4)), torch.zeros(5, 4), [[0.0] * 4] * 2):
        assert ttypes.SearchRequest(queries=q).n_queries() == \
            jtypes.SearchRequest(queries=np.asarray(q)).n_queries()


# ------------------------------------------------------------- synthetic
def test_synthetic_data_matches_reference():
    _same(tsynth.vector_dataset(300, 24, n_clusters=8, seed=3),
          jsynth.vector_dataset(300, 24, n_clusters=8, seed=3))
    x = jsynth.vector_dataset(100, 16, seed=1)
    _same(tsynth.query_stream(x, 9, seed=2), jsynth.query_stream(x, 9, seed=2))
